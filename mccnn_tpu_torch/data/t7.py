"""Torch7 ascii serialization (.t7) reader/writer.

The reference saves trained nets with ``torch.save(fname, {net_te,
opt}, 'ascii')`` (main.lua:566-600), so importing its checkpoints —
and exporting ours back into a shape the reference can load — needs
the Torch7 File serialization format (torch7 lua/File.lua +
THDiskFile ascii mode):

- every value starts with an int type id on its own token:
  0 nil, 1 number, 2 string, 3 table, 4 torch object, 5 boolean;
- numbers are ``%g`` doubles; ints/longs are plain decimal tokens;
  all scalar writes are whitespace-terminated (tokenizable);
- strings/char data: an int byte count, one separator char, then the
  raw bytes (may contain spaces), then a newline;
- tables: a 1-based object index (for shared-reference resolution),
  the pair count, then key/value objects; a re-reference serializes
  as the type id + index only;
- torch objects: object index, a version string ("V 1"), the class
  name string, then the payload — tensors write ndim, size[],
  stride[], 1-based storage offset and their storage object; storages
  write length then elements; any other class writes its fields as
  one table object.

Tensors deserialize to numpy arrays (CudaTensor included — the
reference checkpoints hold CudaTensors, data is plain float); classed
objects become :class:`T7Object` with a ``fields`` dict.

A copy of the JAX package's ``mccnn_tpu/data/t7.py`` (numpy only): both
packages read and write the same files, byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5

_TENSOR_DTYPES = {
    "torch.FloatTensor": np.float32,
    "torch.CudaTensor": np.float32,
    "torch.DoubleTensor": np.float64,
    "torch.ByteTensor": np.uint8,
    "torch.CharTensor": np.int8,
    "torch.ShortTensor": np.int16,
    "torch.IntTensor": np.int32,
    "torch.LongTensor": np.int64,
}
_STORAGE_DTYPES = {
    "torch.FloatStorage": np.float32,
    "torch.CudaStorage": np.float32,
    "torch.DoubleStorage": np.float64,
    "torch.ByteStorage": np.uint8,
    "torch.CharStorage": np.int8,
    "torch.ShortStorage": np.int16,
    "torch.IntStorage": np.int32,
    "torch.LongStorage": np.int64,
}
_STORAGE_FOR = {t: t.replace("Tensor", "Storage") for t in _TENSOR_DTYPES}


@dataclass
class T7Object:
    """A classed torch object that is not a tensor/storage (e.g.
    ``nn.Sequential``); ``fields`` holds its serialized table."""

    torch_typename: str
    fields: dict

    def __getitem__(self, k):
        return self.fields[k]

    def get(self, k, default=None):
        return self.fields.get(k, default)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.memo: dict[int, Any] = {}

    def _token(self) -> str:
        n = len(self.data)
        while self.pos < n and self.data[self.pos : self.pos + 1].isspace():
            self.pos += 1
        start = self.pos
        while self.pos < n and not self.data[self.pos : self.pos + 1].isspace():
            self.pos += 1
        if start == self.pos:
            raise EOFError("truncated t7 file")
        return self.data[start : self.pos].decode("ascii")

    def read_int(self) -> int:
        return int(self._token())

    def read_double(self) -> float:
        return float(self._token())

    def read_raw_string(self) -> str:
        n = self.read_int()
        self.pos += 1  # the single separator after the length
        s = self.data[self.pos : self.pos + n]
        if len(s) != n:
            raise EOFError("truncated string")
        self.pos += n
        return s.decode("latin-1")

    def read_object(self) -> Any:
        t = self.read_int()
        if t == TYPE_NIL:
            return None
        if t == TYPE_NUMBER:
            return self.read_double()
        if t == TYPE_BOOLEAN:
            return self.read_int() != 0
        if t == TYPE_STRING:
            return self.read_raw_string()
        if t == TYPE_TABLE:
            index = self.read_int()
            if index in self.memo:
                return self.memo[index]
            out: dict = {}
            self.memo[index] = out
            n = self.read_int()
            for _ in range(n):
                k = self.read_object()
                v = self.read_object()
                if isinstance(k, float) and k.is_integer():
                    k = int(k)
                out[k] = v
            return out
        if t == TYPE_TORCH:
            index = self.read_int()
            if index in self.memo:
                return self.memo[index]
            version = self.read_raw_string()
            classname = version if not version.startswith("V ") else self.read_raw_string()
            if classname in _TENSOR_DTYPES:
                obj = self._read_tensor(classname)
            elif classname in _STORAGE_DTYPES:
                obj = self._read_storage(classname)
            else:
                obj = T7Object(classname, {})
                self.memo[index] = obj
                fields = self.read_object()
                obj.fields = fields if isinstance(fields, dict) else {"_": fields}
                return obj
            self.memo[index] = obj
            return obj
        raise ValueError(f"unsupported t7 type id {t}")

    def _read_tensor(self, classname: str) -> Optional[np.ndarray]:
        ndim = self.read_int()
        size = [self.read_int() for _ in range(ndim)]
        stride = [self.read_int() for _ in range(ndim)]
        offset = self.read_int() - 1
        storage = self.read_object()
        if storage is None or ndim == 0:
            return np.zeros(size, _TENSOR_DTYPES[classname])
        flat = np.asarray(storage)
        itemsize = flat.itemsize
        return np.lib.stride_tricks.as_strided(
            flat[offset:], shape=size,
            strides=[s * itemsize for s in stride]).copy()

    def _read_storage(self, classname: str) -> np.ndarray:
        n = self.read_int()
        dtype = _STORAGE_DTYPES[classname]
        if classname == "torch.CharStorage":
            # char data is written raw (it is how strings serialize)
            self.pos += 1
            raw = self.data[self.pos : self.pos + n]
            self.pos += n
            return np.frombuffer(raw, np.int8).copy()
        return np.asarray([self.read_double() for _ in range(n)], dtype)


def load_t7_ascii(path: str) -> Any:
    with open(path, "rb") as f:
        return _Reader(f.read()).read_object()


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class Tensor:
    """Marks an array to serialize as a given torch tensor class."""

    def __init__(self, array: np.ndarray, classname: str = "torch.FloatTensor"):
        self.array = np.asarray(array)
        self.classname = classname


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []
        self.memo: dict[int, int] = {}
        self.counter = 0

    def _line(self, s: str) -> None:
        self.parts.append(s.encode("ascii") + b"\n")

    def write_int(self, v: int) -> None:
        self._line(str(int(v)))

    def write_double(self, v: float) -> None:
        self._line(repr(float(v)))

    def write_raw_string(self, s: str) -> None:
        b = s.encode("latin-1")
        self.write_int(len(b))
        self.parts.append(b + b"\n")

    def _ref(self, obj) -> Optional[int]:
        """Existing object index, or None after registering it."""
        key = id(obj)
        if key in self.memo:
            return self.memo[key]
        self.counter += 1
        self.memo[key] = self.counter
        return None

    def write_object(self, obj: Any) -> None:
        if obj is None:
            self.write_int(TYPE_NIL)
        elif isinstance(obj, bool):
            self.write_int(TYPE_BOOLEAN)
            self.write_int(1 if obj else 0)
        elif isinstance(obj, (int, float)):
            self.write_int(TYPE_NUMBER)
            self.write_double(obj)
        elif isinstance(obj, str):
            self.write_int(TYPE_STRING)
            self.write_raw_string(obj)
        elif isinstance(obj, (list, tuple)):
            self.write_object({i + 1: v for i, v in enumerate(obj)})
        elif isinstance(obj, dict):
            self.write_int(TYPE_TABLE)
            ref = self._ref(obj)
            if ref is not None:
                self.write_int(ref)
                return
            self.write_int(self.memo[id(obj)])
            self.write_int(len(obj))
            for k, v in obj.items():
                self.write_object(float(k) if isinstance(k, int) else k)
                self.write_object(v)
        elif isinstance(obj, (Tensor, np.ndarray)):
            self._write_tensor(obj if isinstance(obj, Tensor) else Tensor(obj))
        elif isinstance(obj, T7Object):
            self.write_int(TYPE_TORCH)
            ref = self._ref(obj)
            if ref is not None:
                self.write_int(ref)
                return
            self.write_int(self.memo[id(obj)])
            self.write_raw_string("V 1")
            self.write_raw_string(obj.torch_typename)
            self.write_object(obj.fields)
        else:
            raise TypeError(f"cannot serialize {type(obj)} to t7")

    def _write_tensor(self, t: Tensor) -> None:
        a = np.ascontiguousarray(t.array)
        self.write_int(TYPE_TORCH)
        ref = self._ref(t)
        if ref is not None:
            self.write_int(ref)
            return
        self.write_int(self.memo[id(t)])
        self.write_raw_string("V 1")
        self.write_raw_string(t.classname)
        self.write_int(a.ndim)
        self._line(" ".join(str(s) for s in a.shape))
        strides = [int(np.prod(a.shape[i + 1 :], dtype=np.int64))
                   for i in range(a.ndim)]
        self._line(" ".join(str(s) for s in strides))
        self.write_int(1)  # storage offset (1-based)
        # the storage
        self.write_int(TYPE_TORCH)
        self.counter += 1
        self.write_int(self.counter)
        self.write_raw_string("V 1")
        self.write_raw_string(_STORAGE_FOR[t.classname])
        flat = a.ravel()
        self.write_int(flat.size)
        self._line(" ".join(repr(float(v)) for v in flat))


def dump_t7_ascii(obj: Any, path: str) -> None:
    w = _Writer()
    w.write_object(obj)
    with open(path, "wb") as f:
        f.write(b"".join(w.parts))
