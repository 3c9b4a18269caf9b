"""Pure-Python 7z archive reader, stdlib only (port of the JAX package's
utils/sevenzip.py).

Supported: LZMA2, LZMA1, BZip2, Deflate and Copy coders (the defaults
of 7-Zip, p7zip and py7zr), multiple folders, sub-streams, encoded
(compressed) headers, empty files and directories.  Not supported, with
clear errors: encrypted archives (AES-7z), multi-coder filter chains
(BCJ/BCJ2/Delta), external data references.

Layout summary (7zFormat.txt):
  SignatureHeader(32) = magic(6) version(2) startHeaderCRC(4) +
      StartHeader{ nextHeaderOffset(8) nextHeaderSize(8) nextHeaderCRC(4) }
  NextHeader = kEncodedHeader StreamsInfo   (header itself compressed)
             | kHeader [kMainStreamsInfo] [kFilesInfo] kEnd
"""

from __future__ import annotations

import bz2
import io
import lzma
import zlib
from typing import Iterator, Optional

MAGIC = b"7z\xbc\xaf\x27\x1c"

# property ids
K_END = 0x00
K_HEADER = 0x01
K_MAIN_STREAMS = 0x04
K_FILES_INFO = 0x05
K_PACK_INFO = 0x06
K_UNPACK_INFO = 0x07
K_SUBSTREAMS = 0x08
K_SIZE = 0x09
K_CRC = 0x0A
K_FOLDER = 0x0B
K_CODERS_UNPACK_SIZE = 0x0C
K_NUM_UNPACK_STREAM = 0x0D
K_EMPTY_STREAM = 0x0E
K_EMPTY_FILE = 0x0F
K_NAME = 0x11
K_ENCODED_HEADER = 0x17

# coder ids
CODER_COPY = b"\x00"
CODER_LZMA2 = b"\x21"
CODER_LZMA1 = b"\x03\x01\x01"
CODER_BZIP2 = b"\x04\x02\x02"
CODER_DEFLATE = b"\x04\x01\x08"
CODER_AES = b"\x06\xf1\x07\x01"


class SevenZipError(ValueError):
    """Malformed or unsupported 7z archive."""


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise SevenZipError("truncated 7z header")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise SevenZipError("truncated 7z header")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def number(self) -> int:
        """7z variable-length u64: high bits of the first byte give the
        count of extra little-endian bytes."""
        first = self.byte()
        mask = 0x80
        value = 0
        for i in range(8):
            if not (first & mask):
                value |= (first & (mask - 1)) << (8 * i)
                return value
            value |= self.byte() << (8 * i)
            mask >>= 1
        return value

    def bitfield(self, count: int) -> list[bool]:
        bits: list[bool] = []
        b = 0
        mask = 0
        for _ in range(count):
            if mask == 0:
                b = self.byte()
                mask = 0x80
            bits.append(bool(b & mask))
            mask >>= 1
        return bits

    def bitfield_all_defined(self, count: int) -> list[bool]:
        if self.byte():  # allAreDefined
            return [True] * count
        return self.bitfield(count)

    def skip_to_end(self) -> None:
        """Skip properties until kEnd (size-prefixed blocks)."""
        while True:
            pid = self.number()
            if pid == K_END:
                return
            size = self.number()
            self.read(size)


class _Coder:
    __slots__ = ("id", "props", "nin", "nout")

    def __init__(self, cid: bytes, props: bytes, nin: int, nout: int):
        self.id = cid
        self.props = props
        self.nin = nin
        self.nout = nout


class _Folder:
    __slots__ = ("coders", "bind_pairs", "packed_indices", "unpack_sizes",
                 "num_unpack_streams", "sub_sizes")

    def __init__(self) -> None:
        self.coders: list[_Coder] = []
        self.bind_pairs: list[tuple[int, int]] = []
        self.packed_indices: list[int] = []
        self.unpack_sizes: list[int] = []
        self.num_unpack_streams = 1
        self.sub_sizes: list[int] = []

    @property
    def unpack_size(self) -> int:
        """Output size of the folder = size of the out-stream that no
        bind pair consumes."""
        bound_outs = {o for _, o in self.bind_pairs}
        for i in range(len(self.unpack_sizes) - 1, -1, -1):
            if i not in bound_outs:
                return self.unpack_sizes[i]
        return self.unpack_sizes[-1] if self.unpack_sizes else 0


def _read_folder(r: _Reader) -> _Folder:
    f = _Folder()
    num_coders = r.number()
    total_in = total_out = 0
    for _ in range(num_coders):
        flags = r.byte()
        id_size = flags & 0x0F
        cid = r.read(id_size)
        if flags & 0x10:  # complex coder
            nin = r.number()
            nout = r.number()
        else:
            nin = nout = 1
        props = b""
        if flags & 0x20:
            props = r.read(r.number())
        if flags & 0x80:
            raise SevenZipError("alternative coder methods not supported")
        f.coders.append(_Coder(cid, props, nin, nout))
        total_in += nin
        total_out += nout
    for _ in range(total_out - 1):
        f.bind_pairs.append((r.number(), r.number()))
    num_packed = total_in - len(f.bind_pairs)
    if num_packed == 1:
        bound_ins = {i for i, _ in f.bind_pairs}
        f.packed_indices = [next(i for i in range(total_in)
                                 if i not in bound_ins)]
    else:
        f.packed_indices = [r.number() for _ in range(num_packed)]
    return f


def _decode_folder(folder: _Folder, packs: list[bytes]) -> bytes:
    """Decode one folder's packed streams to its output bytes."""
    for c in folder.coders:
        if c.id == CODER_AES:
            raise SevenZipError("encrypted 7z archives are not supported")
    if len(folder.coders) != 1:
        ids = [c.id.hex() for c in folder.coders]
        raise SevenZipError(
            f"multi-coder 7z folders (filter chains {ids}) not supported")
    coder = folder.coders[0]
    data = packs[0]
    out_size = folder.unpack_size
    if coder.id == CODER_COPY:
        return data[:out_size]
    if coder.id == CODER_LZMA2:
        spec = lzma._decode_filter_properties(  # noqa: SLF001 — stable
            lzma.FILTER_LZMA2, coder.props)     # CPython API since 3.3
        dec = lzma.LZMADecompressor(lzma.FORMAT_RAW, filters=[spec])
        return dec.decompress(data, max_length=out_size)
    if coder.id == CODER_LZMA1:
        spec = lzma._decode_filter_properties(  # noqa: SLF001
            lzma.FILTER_LZMA1, coder.props)
        dec = lzma.LZMADecompressor(lzma.FORMAT_RAW, filters=[spec])
        # LZMA1 streams in 7z have no end marker: stop at out_size
        return dec.decompress(data, max_length=out_size)
    if coder.id == CODER_BZIP2:
        return bz2.decompress(data)[:out_size]
    if coder.id == CODER_DEFLATE:
        return zlib.decompress(data, -15)[:out_size]
    raise SevenZipError(f"unsupported 7z coder id {coder.id.hex()}")


class _StreamsInfo:
    __slots__ = ("pack_pos", "pack_sizes", "folders")

    def __init__(self) -> None:
        self.pack_pos = 0
        self.pack_sizes: list[int] = []
        self.folders: list[_Folder] = []


def _read_streams_info(r: _Reader) -> _StreamsInfo:
    info = _StreamsInfo()
    while True:
        pid = r.number()
        if pid == K_END:
            return info
        if pid == K_PACK_INFO:
            info.pack_pos = r.number()
            num_pack = r.number()
            while True:
                sub = r.number()
                if sub == K_END:
                    break
                if sub == K_SIZE:
                    info.pack_sizes = [r.number() for _ in range(num_pack)]
                elif sub == K_CRC:
                    defined = r.bitfield_all_defined(num_pack)
                    r.read(4 * sum(defined))
                else:
                    raise SevenZipError(f"unexpected id {sub} in PackInfo")
        elif pid == K_UNPACK_INFO:
            sub = r.number()
            if sub != K_FOLDER:
                raise SevenZipError("UnpackInfo must start with kFolder")
            num_folders = r.number()
            if r.byte():  # external
                raise SevenZipError("external folder data not supported")
            info.folders = [_read_folder(r) for _ in range(num_folders)]
            sub = r.number()
            if sub != K_CODERS_UNPACK_SIZE:
                raise SevenZipError("expected kCodersUnpackSize")
            for f in info.folders:
                n_out = sum(c.nout for c in f.coders)
                f.unpack_sizes = [r.number() for _ in range(n_out)]
            while True:
                sub = r.number()
                if sub == K_END:
                    break
                if sub == K_CRC:
                    defined = r.bitfield_all_defined(num_folders)
                    r.read(4 * sum(defined))
                else:
                    r.read(r.number())
        elif pid == K_SUBSTREAMS:
            _read_substreams(r, info)
        else:
            r.read(r.number())


def _read_substreams(r: _Reader, info: _StreamsInfo) -> None:
    nums: Optional[list[int]] = None
    while True:
        pid = r.number()
        if pid == K_END:
            break
        if pid == K_NUM_UNPACK_STREAM:
            nums = [r.number() for _ in info.folders]
            for f, n in zip(info.folders, nums):
                f.num_unpack_streams = n
        elif pid == K_SIZE:
            # sizes for all but the last substream of each folder; the
            # last is the remainder of the folder's unpack size
            for f in info.folders:
                if f.num_unpack_streams == 0:
                    continue
                given = [r.number()
                         for _ in range(f.num_unpack_streams - 1)]
                f.sub_sizes = given + [f.unpack_size - sum(given)]
        elif pid == K_CRC:
            total = 0
            for f in info.folders:
                total += f.num_unpack_streams
            # digests only for streams without folder-level CRC; over-
            # reading is impossible since we never stored folder CRCs
            defined = r.bitfield_all_defined(total)
            r.read(4 * sum(defined))
        else:
            r.read(r.number())
    for f in info.folders:
        if not f.sub_sizes:
            f.sub_sizes = ([f.unpack_size]
                           if f.num_unpack_streams == 1 else
                           [f.unpack_size] * f.num_unpack_streams)


def _decode_streams(data: bytes, info: _StreamsInfo) -> list[bytes]:
    """All substream payloads, in order."""
    base = 32 + info.pack_pos
    offsets = [base]
    for s in info.pack_sizes:
        offsets.append(offsets[-1] + s)
    packs = [data[offsets[i]: offsets[i + 1]]
             for i in range(len(info.pack_sizes))]
    out: list[bytes] = []
    pack_idx = 0
    for f in info.folders:
        n_packed = len(f.packed_indices)
        folder_packs = packs[pack_idx: pack_idx + n_packed]
        pack_idx += n_packed
        raw = _decode_folder(f, folder_packs)
        if len(raw) < f.unpack_size:
            raise SevenZipError("7z folder decoded short")
        off = 0
        # a folder with no kSubStreamsInfo block is one whole substream
        for size in f.sub_sizes or [f.unpack_size]:
            out.append(raw[off: off + size])
            off += size
    return out


def _read_files_info(r: _Reader) -> tuple[list[str], list[bool], list[bool]]:
    """Returns (names, has_stream flags, is_empty_file flags)."""
    num_files = r.number()
    names: list[str] = []
    empty_stream = [False] * num_files
    empty_file_bits: list[bool] = []
    while True:
        pid = r.number()
        if pid == K_END:
            break
        size = r.number()
        block = _Reader(r.read(size))
        if pid == K_EMPTY_STREAM:
            empty_stream = block.bitfield(num_files)
        elif pid == K_EMPTY_FILE:
            empty_file_bits = block.bitfield(sum(empty_stream))
        elif pid == K_NAME:
            if block.byte():
                raise SevenZipError("external file names not supported")
            raw = block.data[block.pos:]
            # NUL-terminated UTF-16LE names; split leaves a trailing ''
            names = raw.decode("utf-16-le").split("\x00")[:-1] if raw else []
    has_stream = [not e for e in empty_stream]
    # among empty-stream entries, kEmptyFile marks files (vs directories)
    is_empty_file = []
    ei = 0
    for e in empty_stream:
        if e:
            is_empty_file.append(
                empty_file_bits[ei] if ei < len(empty_file_bits) else False)
            ei += 1
        else:
            is_empty_file.append(False)
    return names, has_stream, is_empty_file


def iter_7z(data: bytes) -> Iterator[tuple[str, bytes]]:
    """Yield ``(member_name, member_bytes)`` for every file in a 7z
    archive (directories skipped).  Raises SevenZipError on malformed or
    unsupported archives."""
    if len(data) < 32 or data[:6] != MAGIC:
        raise SevenZipError("not a 7z archive")
    next_off = int.from_bytes(data[12:20], "little")
    next_size = int.from_bytes(data[20:28], "little")
    start = 32 + next_off
    if start + next_size > len(data):
        raise SevenZipError("truncated 7z archive")
    header = data[start: start + next_size]
    if not header:
        return
    r = _Reader(header)
    pid = r.number()
    if pid == K_ENCODED_HEADER:
        info = _read_streams_info(r)
        decoded = _decode_streams(data, info)
        r = _Reader(b"".join(decoded))
        pid = r.number()
    if pid != K_HEADER:
        raise SevenZipError(f"unexpected 7z header id {pid}")

    streams: list[bytes] = []
    names: list[str] = []
    has_stream: list[bool] = []
    is_empty_file: list[bool] = []
    while True:
        pid = r.number()
        if pid == K_END:
            break
        if pid == K_MAIN_STREAMS:
            info = _read_streams_info(r)
            streams = _decode_streams(data, info)
        elif pid == K_FILES_INFO:
            names, has_stream, is_empty_file = _read_files_info(r)
        else:
            r.read(r.number())

    if not names:
        # streams but no file table: expose as numbered members
        for i, payload in enumerate(streams):
            yield f"member_{i}", payload
        return
    si = 0
    for i, name in enumerate(names):
        if i < len(has_stream) and has_stream[i]:
            payload = streams[si] if si < len(streams) else b""
            si += 1
            yield name, payload
        elif i < len(is_empty_file) and is_empty_file[i]:
            yield name, b""
        # else: directory — skip
