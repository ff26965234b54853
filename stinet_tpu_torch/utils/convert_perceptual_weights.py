"""Read the JAX package's converted perceptual weights (`.msgpack`).

`stinet_tpu/utils/convert_perceptual_weights.py` writes the VGG16,
InceptionV3 and LPIPS weights it converted from torch files as flax
msgpack: `flax.serialization.msgpack_serialize` of the flax variable tree.
`load_msgpack` decodes such a file into the same tree of dicts, lists and
numpy arrays that flax's `msgpack_restore` gives, with a decoder of its own:
the port imports neither flax nor the `msgpack` package, which the card's
image does not have. The loaders (`models/vgg.py:vgg_from_file`,
`models/inception.py:inception_from_file`,
`metrics/lpips.py:lpips_from_file`) map the tree through the converters of
`utils/convert.py`.

The format: MessagePack (https://github.com/msgpack/msgpack/blob/master/
spec.md) maps, arrays, strings and numbers, with flax's extension types

  1  ndarray: msgpack of (shape, dtype name, C-order bytes)
  2  complex: msgpack of (real, imag)
  3  numpy scalar: an ndarray of shape (), returned as its scalar

and arrays above 2**30 bytes split into chunks, written as a map
{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0": ..}}
and put back together here. A bfloat16 array (a dtype numpy lacks) comes
back as float32, exactly.

Writing the format is the JAX package's need, not the port's: the port
reads torch files already.
"""
import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """MessagePack decoder over one buffer."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wanted {n} more of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if 0xd4 <= b <= 0xd8:        # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xd4))
        lengths = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",      # bin
                   0xc7: ">B", 0xc8: ">H", 0xc9: ">I",      # ext
                   0xd9: ">B", 0xda: ">H", 0xdb: ">I",      # str
                   0xdc: ">H", 0xdd: ">I",                  # array
                   0xde: ">H", 0xdf: ">I"}                  # map
        if b in lengths:
            n = self.unpack(lengths[b])
            if b <= 0xc6:
                return bytes(self.take(n))
            if b <= 0xc9:
                return self.ext(n)
            if b <= 0xdb:
                return self.str(n)
            return self.array(n) if b <= 0xdd else self.map(n)
        scalars = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        consts = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in consts:
            return consts[b]
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at byte "
                         f"{self.pos - 1}")

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            real, imag = unpackb(payload)
            return complex(real, imag)
        raise ValueError(f"msgpack: unknown extension type {code}")


def unpackb(data: bytes):
    """Decode one MessagePack object that fills `data`."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes "
                         "after the object")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, buffer = unpackb(payload)
    if dtype == "bfloat16":
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape)


def _from_index_map(d):
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree):
    """Put arrays written in chunks back together, anywhere in `tree`."""
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            flat = np.concatenate(_from_index_map(tree["chunks"]))
            return flat.reshape(_from_index_map(tree["shape"]))
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def load_msgpack(path):
    """The tree a flax msgpack file holds (what the JAX package's
    `load_msgpack` returns): dicts, lists and read-only numpy arrays."""
    with open(path, "rb") as f:
        return _unchunk(unpackb(f.read()))
