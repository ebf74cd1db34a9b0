"""Filter (codec) pipeline for chunked TH5 datasets — HDF5's filter stack.

HDF5 runs every chunk through an ordered filter pipeline (shuffle, deflate,
user filters) before it reaches the file; the chunk index then records the
*post-filter* byte extent.  Jin et al. ("Accelerating Parallel Write via
Deeply Integrating Predictive Lossy Compression with HDF5", 2022) showed the
filters must be fused *into* the parallel write pipeline — overlapped with
aggregation, not bolted on after it.  This module supplies the codecs; the
overlapped encode-while-writing stage lives in
:class:`repro.core.aggregation.ChunkPipeline`, and the on-disk chunk-record
layout is specified in ``docs/FORMAT.md``.

Four codecs (ids are stable on-disk values — never renumber):

  ==== ================ ========= =======================================
  id   name             lossless  payload
  ==== ================ ========= =======================================
  0    ``none``         yes       raw little-endian chunk bytes
  1    ``zlib``         yes       DEFLATE (RFC 1950) of the raw bytes
  2    ``int8-blockq``  no        per-256-block f32 scales + int8 mantissas
  3    ``shuffle+zlib`` yes       DEFLATE of the byte-shuffled chunk bytes
  ==== ================ ========= =======================================

``shuffle+zlib`` is HDF5's byte-shuffle pre-filter fused with deflate: the
raw chunk bytes are viewed as ``(n_elems, itemsize)`` and transposed, so all
first bytes of every element come first, then all second bytes, and so on.
Fixed-point-ish scientific f32/f64 fields share exponent and high-mantissa
bytes across neighbouring elements; grouping them into byte planes hands
zlib long runs it can actually exploit (measured: 1.88:1 → ~2.5:1 on the
benchmark field data).  The shuffle itself is a pure permutation — decoding
transposes back, so the filter stays bit-exact lossless.

``int8-blockq`` is the lossy scientific-data codec: the same per-block
quantiser as ``repro.distributed.compression`` (the DCN gradient compressor),
re-implemented host-side in numpy so the I/O path never touches jax.  Scales
are stored with the payload, so the reconstruction error is bounded by
``scale/2 = max|block|/254`` per element — the "stored-scale tolerance" the
round-trip property tests assert.

Every encoder may *fall back* to ``none`` when the encoded payload would be
no smaller than the raw chunk (incompressible data); the per-chunk
``codec_id`` in the chunk record is what makes that safe.

Copied from ``src/repro/core/codecs.py``; only the import lines differ.
"""

from __future__ import annotations

import zlib
from typing import Any

import numpy as np

CODEC_NONE = 0
CODEC_ZLIB = 1
CODEC_INT8_BLOCKQ = 2
CODEC_SHUFFLE_ZLIB = 3

BLOCK = 256  # quantiser block length — mirrors repro.distributed.compression.BLOCK


def _byte_view(a: np.ndarray) -> memoryview:
    """Flat byte view of a contiguous array (buffer-protocol dance for
    extension dtypes like bfloat16) — no copy."""
    if a.size == 0:
        return memoryview(b"")  # cast('B') rejects zeros in shape
    try:
        return memoryview(a).cast("B")
    except (ValueError, TypeError):
        return memoryview(a.view(np.uint8)).cast("B")


class Codec:
    """One filter: raw chunk bytes <-> stored payload."""

    name: str = "?"
    codec_id: int = -1
    lossless: bool = True

    def encode(self, arr: np.ndarray) -> bytes | memoryview:
        raise NotImplementedError

    def decode(self, blob: bytes | memoryview, dtype: np.dtype, n_elems: int) -> np.ndarray:
        """Return a flat (n_elems,) array in *native* byte order."""
        raise NotImplementedError


class NoneCodec(Codec):
    name = "none"
    codec_id = CODEC_NONE
    lossless = True

    def encode(self, arr: np.ndarray) -> memoryview:
        return _byte_view(np.ascontiguousarray(arr))

    def decode(self, blob, dtype: np.dtype, n_elems: int) -> np.ndarray:
        out = np.frombuffer(blob, dtype=dtype, count=n_elems)
        if not (dtype.byteorder in ("|", "=") or dtype.isnative):
            out = out.astype(dtype.newbyteorder("="))
        return out


class ZlibCodec(Codec):
    name = "zlib"
    codec_id = CODEC_ZLIB
    lossless = True

    def __init__(self, level: int = 1):
        # level 1: the write path is bandwidth-bound, not ratio-bound
        self.level = int(level)

    def encode(self, arr: np.ndarray) -> bytes:
        return zlib.compress(_byte_view(np.ascontiguousarray(arr)), self.level)

    def decode(self, blob, dtype: np.dtype, n_elems: int) -> np.ndarray:
        raw = zlib.decompress(blob)
        out = np.frombuffer(raw, dtype=dtype, count=n_elems)
        if not (dtype.byteorder in ("|", "=") or dtype.isnative):
            out = out.astype(dtype.newbyteorder("="))
        return out


def byte_shuffle(raw: bytes | memoryview, itemsize: int) -> np.ndarray:
    """HDF5 shuffle filter: regroup ``raw`` (n_elems × itemsize element
    bytes) into itemsize byte planes.  Pure permutation — inverse is
    :func:`byte_unshuffle`."""
    b = np.frombuffer(raw, dtype=np.uint8)
    if itemsize <= 1 or b.size == 0:
        return b
    if b.size % itemsize:
        raise ValueError(f"{b.size} bytes is not a multiple of itemsize {itemsize}")
    return np.ascontiguousarray(b.reshape(-1, itemsize).T).reshape(-1)


def byte_unshuffle(shuffled: bytes | memoryview, itemsize: int) -> np.ndarray:
    """Invert :func:`byte_shuffle`: byte planes back to element order."""
    b = np.frombuffer(shuffled, dtype=np.uint8)
    if itemsize <= 1 or b.size == 0:
        return b
    if b.size % itemsize:
        raise ValueError(f"{b.size} bytes is not a multiple of itemsize {itemsize}")
    return np.ascontiguousarray(b.reshape(itemsize, -1).T).reshape(-1)


class ShuffleZlibCodec(Codec):
    """Byte-shuffle pre-filter + DEFLATE (HDF5's ``shuffle | deflate`` filter
    chain fused into one codec id).  The stored payload is
    ``zlib.compress(byte_shuffle(raw, itemsize))``; decode inflates and
    transposes the byte planes back.  ``itemsize`` is recovered from the
    dtype at decode time — no payload header needed."""

    name = "shuffle+zlib"
    codec_id = CODEC_SHUFFLE_ZLIB
    lossless = True

    def __init__(self, level: int = 1):
        self.level = int(level)

    def encode(self, arr: np.ndarray) -> bytes:
        arr = np.ascontiguousarray(arr)
        itemsize = arr.dtype.itemsize
        return zlib.compress(byte_shuffle(_byte_view(arr), itemsize), self.level)

    def decode(self, blob, dtype: np.dtype, n_elems: int) -> np.ndarray:
        dt = np.dtype(dtype)
        raw = byte_unshuffle(zlib.decompress(blob), dt.itemsize)
        out = np.frombuffer(raw, dtype=dt, count=n_elems)
        if not (dt.byteorder in ("|", "=") or dt.isnative):
            out = out.astype(dt.newbyteorder("="))
        return out


class Int8BlockQCodec(Codec):
    """Lossy block quantiser: per-``BLOCK`` f32 scale + int8 mantissas.

    Payload layout (little-endian)::

        [ n_blocks × '<f4' scales ][ n_blocks × BLOCK × int8 quantised ]

    with ``n_blocks = ceil(n_elems / BLOCK)`` derived from the chunk's
    ``raw_nbytes`` — no header needed.  f32 raw data stores at ~3.9:1.
    """

    name = "int8-blockq"
    codec_id = CODEC_INT8_BLOCKQ
    lossless = False

    def encode(self, arr: np.ndarray) -> bytes:
        f32 = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
        pad = (-f32.size) % BLOCK
        if pad:
            f32 = np.pad(f32, (0, pad))
        blocks = f32.reshape(-1, BLOCK)
        scale = np.maximum(np.abs(blocks).max(axis=1) / 127.0, 1e-12).astype("<f4")
        q = np.clip(np.rint(blocks / scale[:, None]), -127, 127).astype(np.int8)
        return scale.tobytes() + q.tobytes()

    def decode(self, blob, dtype: np.dtype, n_elems: int) -> np.ndarray:
        n_blocks = -(-n_elems // BLOCK)
        scale = np.frombuffer(blob, dtype="<f4", count=n_blocks)
        q = np.frombuffer(blob, dtype=np.int8, offset=4 * n_blocks, count=n_blocks * BLOCK)
        flat = (q.reshape(n_blocks, BLOCK).astype(np.float32) * scale[:, None]).reshape(-1)
        return flat[:n_elems].astype(np.dtype(dtype).newbyteorder("="))

    @staticmethod
    def tolerance(arr: np.ndarray) -> float:
        """Worst-case absolute reconstruction error for ``arr`` (the
        stored-scale bound the property tests check against)."""
        amax = float(np.max(np.abs(np.asarray(arr, dtype=np.float32)))) if np.asarray(arr).size else 0.0
        return 0.5 * amax / 127.0 + 1e-6


_BY_ID: dict[int, Codec] = {
    CODEC_NONE: NoneCodec(),
    CODEC_ZLIB: ZlibCodec(),
    CODEC_INT8_BLOCKQ: Int8BlockQCodec(),
    CODEC_SHUFFLE_ZLIB: ShuffleZlibCodec(),
}
CODEC_NAMES: tuple[str, ...] = tuple(c.name for c in _BY_ID.values())


def get_codec(spec: str) -> Codec:
    """Resolve a codec spec: ``none``, ``zlib``, ``zlib:<level>``,
    ``int8-blockq``, ``shuffle+zlib``, ``shuffle+zlib:<level>``."""
    name, _, param = str(spec).partition(":")
    if name == "none":
        return _BY_ID[CODEC_NONE]
    if name == "zlib":
        return ZlibCodec(int(param)) if param else _BY_ID[CODEC_ZLIB]
    if name == "int8-blockq":
        return _BY_ID[CODEC_INT8_BLOCKQ]
    if name == "shuffle+zlib":
        return ShuffleZlibCodec(int(param)) if param else _BY_ID[CODEC_SHUFFLE_ZLIB]
    raise ValueError(f"unknown codec {spec!r} (have {CODEC_NAMES})")


def codec_by_id(codec_id: int) -> Codec:
    try:
        return _BY_ID[int(codec_id)]
    except KeyError:
        raise ValueError(f"unknown codec id {codec_id}") from None


def encode_chunk(codec: Codec, arr: np.ndarray) -> tuple[Any, int, int, int, int]:
    """Run one chunk through the filter, with the incompressible fallback.

    Returns ``(payload, raw_nbytes, raw_crc32, stored_crc32, codec_id)``.
    ``payload`` is a zero-copy byte view for the ``none`` codec (and for the
    fallback), a fresh bytes object otherwise.
    """
    arr = np.ascontiguousarray(arr)
    raw = _byte_view(arr)
    raw_nbytes = len(raw)
    raw_crc = zlib.crc32(raw) & 0xFFFFFFFF
    if codec.codec_id == CODEC_NONE:
        return raw, raw_nbytes, raw_crc, raw_crc, CODEC_NONE
    blob = codec.encode(arr)
    if len(blob) >= raw_nbytes:  # incompressible: store raw, flag per-chunk
        return raw, raw_nbytes, raw_crc, raw_crc, CODEC_NONE
    stored_crc = zlib.crc32(blob) & 0xFFFFFFFF
    return blob, raw_nbytes, raw_crc, stored_crc, codec.codec_id


def encode_chunk_with_stats(
    codec: Codec, arr: np.ndarray
) -> tuple[Any, int, int, int, int, Any]:
    """:func:`encode_chunk` plus the chunk-statistics summary for the
    predicate-pushdown index (``query.ChunkStats``, or ``None`` when the
    dtype has no usable ordering).

    For a lossy codec the summary is computed on the **decoded** payload —
    the values a reader will actually see — so the stored min/max genuinely
    bracket every decodable value and pruning on them is sound.  The
    incompressible fallback stores raw bytes (``codec_id == 0``), which is
    lossless, so source values are summarised in that case.
    """
    from .query import compute_chunk_stats  # local: keep codecs import-light

    payload, raw_nbytes, raw_crc, stored_crc, cid = encode_chunk(codec, arr)
    src = arr
    roundtrip = codec_by_id(cid)
    if not roundtrip.lossless:
        a = np.ascontiguousarray(arr)
        src = roundtrip.decode(payload, a.dtype, a.size).reshape(a.shape)
    stats = compute_chunk_stats(src, raw_crc)
    return payload, raw_nbytes, raw_crc, stored_crc, cid, stats
