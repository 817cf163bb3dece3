"""The port's first-party zstd decoder (its XXH64 content checksums
included), raw-block frame writer and CRC32C
(raglite_tpu_torch/native/zstd.cpp) against the ``zstandard`` package and
published check values, on the CPU.

Decoded bytes must equal the input exactly; every failure is a ValueError
naming its cause.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from raglite_tpu_torch import native

zstandard = pytest.importorskip("zstandard")

LEVELS = (-5, 1, 3, 9, 19)


def _decode(frames: bytes, size: int) -> bytes:
    out = np.empty(size, np.uint8)
    native.zstd_decompress(frames, out)
    return out.tobytes()


def _compress(data: bytes, level: int, *, checksum=False, content_size=True, ldm=False) -> bytes:
    params = zstandard.ZstdCompressionParameters.from_level(
        level, write_checksum=checksum, write_content_size=content_size, enable_ldm=ldm
    )
    return zstandard.ZstdCompressor(compression_params=params).compress(data)


def _streamed(data: bytes, level: int, *, piece: int = 50_000) -> bytes:
    """A frame written in pieces (no content size, as tensorstore's chunks
    are written), flushed between pieces so that blocks end early."""
    c = zstandard.ZstdCompressor(level=level).compressobj()
    out = b""
    for i in range(0, len(data), piece):
        out += c.compress(data[i : i + piece]) + c.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
    return out + c.flush()


def _corpus(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    text = b"the speed of light in vacuum is the same for all observers; " * 40
    weights = (rng.standard_normal(200_000) * 0.02).astype(np.float32)
    bf16 = (weights.view(np.uint32) >> 16).astype(np.uint16).tobytes()  # bf16 words
    return [
        b"",
        b"x",
        bytes(70_000),  # RLE blocks
        rng.integers(0, 256, 3_000, dtype=np.uint8).tobytes(),  # raw (incompressible)
        text + rng.integers(0, 256, 500, dtype=np.uint8).tobytes() + text,
        bf16,  # Huffman literals over several blocks
        rng.zipf(1.4, 300_000).astype(np.uint8).tobytes(),
        # a repeat 1 MB back: long-distance matching reaches it
        (lambda b: b + rng.integers(0, 4, 50_000, dtype=np.uint8).tobytes() + b)(
            rng.integers(0, 256, 400_000, dtype=np.uint8).tobytes()
        ),
    ]


@pytest.mark.parametrize("level", LEVELS)
def test_levels_against_zstandard(level: int) -> None:
    """Every corpus entry at the level, with and without checksums, content
    sizes and long-distance matching, and streamed without a size."""
    for data in _corpus(level + 100):
        for checksum, content_size, ldm in ((False, True, False), (True, False, False), (True, True, True)):
            frame = _compress(data, level, checksum=checksum, content_size=content_size, ldm=ldm)
            assert _decode(frame, len(data)) == data
        assert _decode(_streamed(data, level), len(data)) == data


@st.composite
def _mixed(draw) -> bytes:
    """Runs of random bytes, repeats of earlier bytes (near and far) and
    byte runs: matches, repeat offsets and literal runs of every length."""
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    out = bytearray()
    for _ in range(draw(st.integers(1, 40))):
        kind = draw(st.sampled_from(["random", "copy", "run", "text"]))
        n = draw(st.integers(0, 9_000))
        if kind == "random":
            out += rng.integers(0, draw(st.sampled_from([2, 16, 256])), n, dtype=np.uint8).tobytes()
        elif kind == "copy" and out:
            start = draw(st.integers(0, len(out) - 1))
            piece = bytes(out[start : start + n])
            out += piece
        elif kind == "run":
            out += bytes([draw(st.integers(0, 255))]) * n
        else:
            out += b"abcabd, the cat sat on the mat. "[: draw(st.integers(1, 32))] * (n // 32 + 1)
    return bytes(out)


@settings(max_examples=40, deadline=None)
@given(data=_mixed(), level=st.sampled_from(LEVELS), checksum=st.booleans(), ldm=st.booleans())
def test_hypothesis_data_against_zstandard(data: bytes, level: int, checksum: bool, ldm: bool) -> None:
    frame = _compress(data, level, checksum=checksum, content_size=False, ldm=ldm)
    assert _decode(frame, len(data)) == data


def test_concatenated_and_skippable_frames() -> None:
    a, b = b"first frame " * 3_000, np.arange(100_000, dtype=np.uint16).tobytes()
    skip = (0x184D2A5E).to_bytes(4, "little") + (7).to_bytes(4, "little") + b"ignored"
    frames = skip + _compress(a, 3, checksum=True) + skip + _streamed(b, 1) + bytes(native.zstd_raw_frame(a))
    assert _decode(frames, 2 * len(a) + len(b)) == a + b + a


@pytest.mark.parametrize("size", [0, 1, 131_071, 131_072, 131_073, 400_000])
def test_raw_frame_is_read_by_zstandard(size: int) -> None:
    """The writer's frames (raw blocks of up to 128 KiB, content size
    declared) decode with zstandard and with the port's decoder."""
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    frame = native.zstd_raw_frame(data).tobytes()
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstandard.get_frame_parameters(frame).content_size == size
    assert _decode(frame, size) == data
    assert len(frame) - size == 10 + 3 * max(1, -(-size // 131_072))


def test_errors_are_named() -> None:
    data = b"checksummed content " * 500
    frame = _compress(data, 3, checksum=True)
    with pytest.raises(ValueError, match="truncated"):
        _decode(frame[:-7], len(data))
    with pytest.raises(ValueError, match="more bytes than expected"):
        _decode(frame, len(data) - 1)
    with pytest.raises(ValueError, match="fewer bytes than expected"):
        _decode(frame, len(data) + 1)
    bad = frame[:-1] + bytes([frame[-1] ^ 0x40])
    with pytest.raises(ValueError, match="checksum mismatch"):
        _decode(bad, len(data))
    with pytest.raises(ValueError, match="bad magic"):
        _decode(b"\x00" * 16 + frame, len(data))
    raw = native.zstd_raw_frame(data).tobytes()  # magic, descriptor, window, 4-byte content size
    with pytest.raises(ValueError, match="content size mismatch"):
        _decode(raw[:6] + (len(data) + 1).to_bytes(4, "little") + raw[10:], len(data))


def test_unsized_decode_returns_its_length() -> None:
    data = b"orbax node body " * 100
    out = np.empty(10 * len(data), np.uint8)
    n = native.zstd_decompress(_streamed(data, 1), out, exact=False)
    assert out[:n].tobytes() == data


def test_threads_decode_at_once() -> None:
    """Leaves decode on a thread pool (ctypes releases the GIL): each
    thread's output and error message are its own."""
    corpus = [d for d in _corpus(7) if d]
    frames = [_compress(d, 1, checksum=True) for d in corpus]

    def work(i: int):
        j = i % len(corpus)
        if i % 5 == 4:
            with pytest.raises(ValueError, match="fewer bytes"):
                _decode(frames[j], len(corpus[j]) + 3)
            return True
        return _decode(frames[j], len(corpus[j])) == corpus[j]

    with ThreadPoolExecutor(8) as pool:
        assert all(pool.map(work, range(64)))


def test_crc32c() -> None:
    assert native.crc32c(b"123456789") == 0xE3069283  # RFC 3720's check value
    assert native.crc32c(b"") == 0
    assert native.crc32c(bytes(32)) == 0x8A9136AA  # RFC 3720, B.4: 32 bytes of zeros
