"""Read and write `.safetensors` files with numpy and torch alone.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor name to its dtype, shape and byte range, then the raw
little-endian bytes (https://github.com/huggingface/safetensors). The
`safetensors` package is not needed, and BF16 is read, which its numpy
framework cannot represent (ROADMAP.md C). A tensor read here is a view of
the file's copy-on-write memory map: nothing is read from disk or copied
until the tensor is used.
"""

import json
import struct

import numpy as np
import torch

# safetensors dtype -> (numpy storage dtype, torch dtype)
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}


class SafetensorsFile:
    """The tensors of one `.safetensors` file, read lazily."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.path = path
        self._header = header
        self._start = 8 + n
        self._map = np.memmap(path, dtype=np.uint8, mode="c")

    def keys(self):
        return list(self._header)

    def get_tensor(self, name: str) -> torch.Tensor:
        info = self._header[name]
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{self.path}: {name} has unsupported dtype {info['dtype']}")
        np_dt, torch_dt = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        raw = self._map[self._start + begin : self._start + end]
        arr = raw.view(np_dt) if raw.ctypes.data % np.dtype(np_dt).itemsize == 0 else \
            np.frombuffer(raw.tobytes(), np_dt)  # an unaligned range is copied
        t = torch.from_numpy(arr.reshape(info["shape"]))
        return t.view(torch_dt) if torch_dt == torch.bfloat16 else t


def save_file(tensors: dict, path: str) -> None:
    """Write {name: tensor} (on any device) as one `.safetensors` file, in
    name order, the header padded so that the data starts 8-byte aligned."""
    header, offset = {}, 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(memoryview(t.reshape(-1).numpy()).cast("B"))
