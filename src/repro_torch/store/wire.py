"""The msgpack subset the store writes, byte-identical to the ``msgpack``
package.

The store's objects and its ``meta.msgpack`` are msgpack.  :func:`packb`
gives the same bytes as ``msgpack.packb(obj, use_bin_type=True)`` and
:func:`unpackb` the same values as ``msgpack.unpackb(data, raw=False)`` for
the types the store writes: dict, list (and tuple, packed as an array), str,
bytes (and bytearray / memoryview, packed as bin), int, float, bool and None.
Keeping the format here keeps the port free of the ``msgpack`` package, and
stores written by either package open in the other.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List, Tuple

__all__ = ["packb", "unpackb"]

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def packb(obj: Any) -> bytes:
    """Serialize ``obj`` as ``msgpack.packb(obj, use_bin_type=True)`` does."""
    out: List[bytes] = []
    _pack(obj, out.append)
    return b"".join(out)


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, int, int],
              emit: Callable[[bytes], None], what: str) -> None:
    """Header of a str / bin / array / map of length ``n``; ``fix`` is the
    fix-format base byte (0 where the type has none), ``codes`` the 8-, 16-
    and 32-bit length formats (0 where the type lacks one)."""
    c8, c16, c32 = codes
    if fix and n <= fix_max:
        emit(bytes((fix | n,)))
    elif c8 and n < 1 << 8:
        emit(bytes((c8, n)))
    elif n < 1 << 16:
        emit(bytes((c16,)) + _U16.pack(n))
    elif n < 1 << 32:
        emit(bytes((c32,)) + _U32.pack(n))
    else:
        raise ValueError(f"{what} too large for msgpack: {n}")


def _pack(obj: Any, emit: Callable[[bytes], None]) -> None:
    if obj is None:
        emit(b"\xc0")
    elif obj is True:
        emit(b"\xc3")
    elif obj is False:
        emit(b"\xc2")
    elif isinstance(obj, int):
        emit(_pack_int(int(obj)))
    elif isinstance(obj, float):
        emit(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), emit, "str")
        emit(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = obj if isinstance(obj, bytes) else bytes(obj)
        _pack_len(len(data), 0, 0, (0xC4, 0xC5, 0xC6), emit, "bin")
        emit(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (0, 0xDC, 0xDD), emit, "array")
        for item in obj:
            _pack(item, emit)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (0, 0xDE, 0xDF), emit, "map")
        for key, value in obj.items():
            _pack(key, emit)
            _pack(value, emit)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(v: int) -> bytes:
    if v >= 0:
        if v < 1 << 7:
            return bytes((v,))
        if v < 1 << 8:
            return b"\xcc" + _U8.pack(v)
        if v < 1 << 16:
            return b"\xcd" + _U16.pack(v)
        if v < 1 << 32:
            return b"\xce" + _U32.pack(v)
        if v < 1 << 64:
            return b"\xcf" + _U64.pack(v)
    else:
        if v >= -(1 << 5):
            return _I8.pack(v)  # negative fixint is the byte itself
        if v >= -(1 << 7):
            return b"\xd0" + _I8.pack(v)
        if v >= -(1 << 15):
            return b"\xd1" + _I16.pack(v)
        if v >= -(1 << 31):
            return b"\xd2" + _I32.pack(v)
        if v >= -(1 << 63):
            return b"\xd3" + _I64.pack(v)
    raise OverflowError("Integer value out of range")


# ------------------------------------------------------------------ unpack
def unpackb(data: bytes) -> Any:
    """Deserialize as ``msgpack.unpackb(data, raw=False)`` does: maps to
    dicts, arrays to lists, str to str, bin to bytes."""
    data = bytes(data)
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError(f"extra data: {len(data) - pos} bytes after the object")
    return obj


_FIXED = {
    0xC0: None, 0xC2: False, 0xC3: True,
}
# code -> (struct, size) for scalars
_SCALARS = {
    0xCA: _F32, 0xCB: _F64,
    0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
    0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64,
}
_STR_LEN = {0xD9: _U8, 0xDA: _U16, 0xDB: _U32}
_BIN_LEN = {0xC4: _U8, 0xC5: _U16, 0xC6: _U32}
_ARRAY_LEN = {0xDC: _U16, 0xDD: _U32}
_MAP_LEN = {0xDE: _U16, 0xDF: _U32}


def _take(data: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    end = pos + n
    if end > len(data):
        raise ValueError("truncated msgpack data")
    return data[pos:end], end


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    if pos >= len(data):
        raise ValueError("truncated msgpack data")
    code = data[pos]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0xA0 <= code <= 0xBF:
        raw, pos = _take(data, pos, code & 0x1F)
        return raw.decode("utf-8"), pos
    if 0x90 <= code <= 0x9F:
        return _unpack_array(data, pos, code & 0x0F)
    if 0x80 <= code <= 0x8F:
        return _unpack_map(data, pos, code & 0x0F)
    if code in _FIXED:
        return _FIXED[code], pos
    if code in _SCALARS:
        st = _SCALARS[code]
        raw, pos = _take(data, pos, st.size)
        return st.unpack(raw)[0], pos
    for table, kind in (
        (_STR_LEN, "str"), (_BIN_LEN, "bin"),
        (_ARRAY_LEN, "array"), (_MAP_LEN, "map"),
    ):
        st = table.get(code)
        if st is None:
            continue
        raw, pos = _take(data, pos, st.size)
        n = st.unpack(raw)[0]
        if kind == "array":
            return _unpack_array(data, pos, n)
        if kind == "map":
            return _unpack_map(data, pos, n)
        raw, pos = _take(data, pos, n)
        return (raw.decode("utf-8") if kind == "str" else raw), pos
    raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")


def _unpack_array(data: bytes, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _unpack(data, pos)
        out.append(item)
    return out, pos


def _unpack_map(data: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _unpack(data, pos)
        value, pos = _unpack(data, pos)
        out[key] = value
    return out, pos
