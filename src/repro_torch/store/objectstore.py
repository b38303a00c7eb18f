"""Content-addressed object store (the physical layer under the version store).

Blobs are compressed through one :class:`Codec` and stored under the sha256
of their uncompressed bytes; writes are atomic (tmp + rename), so an object
either exists fully or not at all.  Dedup falls out of content addressing.
The key and path layout (``objects/<key[:2]>/<key[2:]>.zst``) is the JAX
package's, so either package opens the other's stores.

``zstandard`` is optional: without it the codec compresses with stdlib
``zlib``.  Decompression dispatches on the frame magic, so zlib-written
stores are readable everywhere and zstd-written ones wherever ``zstandard``
is installed.  (The ``.zst`` suffix is kept for layout stability whatever
the backend; blob contents are self-describing.)
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import zlib
from pathlib import Path
from typing import Iterator, Optional

try:  # optional dependency: stdlib zlib fallback below
    import zstandard
except ImportError:  # pragma: no cover - exercised via Codec(backend="zlib")
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


class Codec:
    """The one compression codec every store byte goes through."""

    def __init__(self, level: int = 3, *, backend: Optional[str] = None) -> None:
        if backend is None:
            backend = "zstd" if zstandard is not None else "zlib"
        if backend == "zstd" and zstandard is None:
            raise RuntimeError("zstandard requested but not installed")
        if backend not in ("zstd", "zlib"):
            raise ValueError(f"unknown codec backend {backend!r}")
        self.backend = backend
        self.level = level
        if backend == "zstd":
            self._c = zstandard.ZstdCompressor(level=level)
            self._d = zstandard.ZstdDecompressor()

    def compress(self, payload: bytes) -> bytes:
        if self.backend == "zstd":
            return self._c.compress(payload)
        # zstd levels reach 22; zlib tops out at 9
        return zlib.compress(payload, min(self.level, 9))

    def decompress(self, blob: bytes) -> bytes:
        # dispatch on frame magic so mixed-backend stores keep working
        if blob[:4] == _ZSTD_MAGIC:
            if zstandard is None:
                raise RuntimeError(
                    "blob was written with zstd but zstandard is not installed"
                )
            if self.backend == "zstd":
                return self._d.decompress(blob)
            return zstandard.ZstdDecompressor().decompress(blob)
        return zlib.decompress(blob)

    def compressed_size(self, payload: bytes) -> int:
        """Bytes this payload would occupy at rest (the measured Δ)."""
        return len(self.compress(payload))


class ObjectStore:
    def __init__(
        self,
        root: str | Path,
        *,
        zstd_level: int = 3,
        codec: Optional[Codec] = None,
    ) -> None:
        self.root = Path(root)
        (self.root / "objects").mkdir(parents=True, exist_ok=True)
        self.codec = codec or Codec(level=zstd_level)

    def _path(self, key: str) -> Path:
        return self.root / "objects" / f"{key[:2]}" / f"{key[2:]}.zst"

    def put(self, payload: bytes) -> tuple[str, int]:
        """Store a blob; returns (key, stored_bytes)."""
        key = hashlib.sha256(payload).hexdigest()
        path = self._path(key)
        if path.exists():
            return key, path.stat().st_size
        path.parent.mkdir(parents=True, exist_ok=True)
        compressed = self.codec.compress(payload)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(compressed)
            os.replace(tmp, path)  # atomic on POSIX
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return key, len(compressed)

    def get(self, key: str) -> bytes:
        return self.codec.decompress(self._path(key).read_bytes())

    def exists(self, key: str) -> bool:
        return self._path(key).exists()

    def stored_size(self, key: str) -> int:
        return self._path(key).stat().st_size

    def delete(self, key: str) -> None:
        p = self._path(key)
        if p.exists():
            p.unlink()

    def keys(self) -> Iterator[str]:
        for sub in (self.root / "objects").iterdir():
            if sub.is_dir():
                for f in sub.iterdir():
                    if f.suffix == ".zst":
                        yield sub.name + f.stem

    def total_bytes(self) -> int:
        return sum(self._path(k).stat().st_size for k in self.keys())
