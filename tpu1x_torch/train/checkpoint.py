"""Model checkpoint readers: the reference's torch layout and the JAX
package's portable layout, both into the reference-named state dict that
`STMaskGIT.load_state_dict` takes.

- A reference directory: `config.json` beside `model.safetensors` or
  `pytorch_model.bin` (`load_torch_checkpoint`). The safetensors file is
  read by a reader of this module's own: an 8-byte little-endian header
  length, a JSON header naming each tensor's dtype, shape and byte range,
  then the raw little-endian bytes.
- A JAX `save_pretrained` directory: `config.json` beside `params.msgpack`
  (`load_pretrained`), flax's msgpack of the parameter tree, where each
  array is msgpack extension type 1 holding (shape, dtype name, C-order
  bytes). It is decoded with the `msgpack` package, imported when needed,
  and carried across by `params_from_jax`.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.weights import params_from_jax

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, on the CPU."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        flat = (torch.frombuffer(bytearray(body[begin:end]), dtype=dtype)
                if end > begin else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def load_torch_checkpoint(path, config: GenieConfig
                          ) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (a `.safetensors` or torch `.bin`/`.pt` file,
    or a directory holding `model.safetensors` or `pytorch_model.bin`) ->
    its state dict, fp32. `config` is the checkpoint's (the JAX reader's
    signature); the names are the reference's and need no mapping."""
    path = Path(path)
    if path.is_dir():
        for cand in ("model.safetensors", "pytorch_model.bin"):
            if (path / cand).exists():
                path = path / cand
                break
        else:
            raise FileNotFoundError(f"no model.safetensors or "
                                    f"pytorch_model.bin in {path}")
    if path.suffix == ".safetensors":
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items()}


def _flax_array(data: bytes) -> np.ndarray:
    """flax's ndarray extension payload -> fp32 (or integer) numpy."""
    import msgpack
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":  # numpy has no bf16: widen through torch
        t = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return t.float().numpy().reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _unchunk(tree):
    """flax splits arrays above 1 GiB into chunks; join them."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path) -> Any:
    """The parameter tree of a flax `to_bytes` file, numpy leaves."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("reading params.msgpack needs the msgpack package; "
                          "a reference torch checkpoint directory does not")\
            from e

    def ext(code, data):
        if code in (1, 3):  # an ndarray, or a numpy scalar packed as one
            arr = _flax_array(data)
            return arr if code == 1 else arr[()]
        return msgpack.ExtType(code, data)
    tree = msgpack.unpackb(Path(path).read_bytes(), ext_hook=ext, raw=False)
    return _unchunk(tree)


def load_pretrained(save_dir) -> Tuple[Dict[str, torch.Tensor], GenieConfig]:
    """A JAX `save_pretrained` directory -> (state dict, config)."""
    save_dir = Path(save_dir)
    config = GenieConfig.from_pretrained(save_dir / "config.json")
    tree = read_flax_msgpack(save_dir / "params.msgpack")
    if "params" in tree:
        tree = tree["params"]
    return params_from_jax(tree, config), config
