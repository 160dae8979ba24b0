"""Checkpoints: the model-only formats shared with the JAX package and the
reference, and the port's full training state.

- A reference directory: `config.json` beside `model.safetensors` or
  `pytorch_model.bin` (`load_torch_checkpoint`, `save_pretrained_torch`).
  Safetensors is read and written here: an 8-byte little-endian header
  length, a JSON header naming each tensor's dtype, shape and byte range,
  then the raw little-endian bytes, back to back.
- A JAX `save_pretrained` directory: `config.json` beside `params.msgpack`
  (`load_pretrained`, `save_pretrained`), flax's msgpack of the parameter
  tree, where each array is msgpack extension type 1 holding (shape, dtype
  name, C-order bytes); encoded and decoded by the port's own codec
  (`_msgpack`) and carried across by `params_from_jax` / `params_to_jax`.
- `Checkpointer`: the full training state under `{output_dir}/{name}`
  (parameters, AdamW moments and steps, `TrainOptimizer`'s counters and
  running mean, the step, the generator), written by
  `torch.distributed.checkpoint`, each rank its own shards under FSDP2
  (and its own dropout generator). Under tensor parallelism the ranks of a
  model group hold different tensors under one parameter name, so each
  split tensor is saved under its name and its share, `.../tp{r}of{tp}`;
  a checkpoint restores only into the layout it was saved from.
  This format is the port's own (Orbax's needs JAX); the model-only
  formats carry weights between the packages.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.train import _msgpack
from tpu1x_torch.weights import params_from_jax, params_to_jax

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


_SAFETENSORS_NAMES = {v: k for k, v in _SAFETENSORS_DTYPES.items()}


def write_safetensors(path, tensors: Dict[str, torch.Tensor]) -> None:
    """Write `tensors` (any device) as a `.safetensors` file, in the order
    given, the header padded with spaces to 8 bytes."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": _SAFETENSORS_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in blobs:
            f.write(data)


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
    shape, dtype_name, buf = _msgpack.unpack(data)
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
    def ext(code, data):
        if code in (1, 3):  # an ndarray, or a numpy scalar packed as one
            arr = _flax_array(data)
            return arr if code == 1 else arr[()]
        return _msgpack.ExtType(code, data)
    return _unchunk(_msgpack.unpack(Path(path).read_bytes(), ext_hook=ext))


_FLAX_CHUNK = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE, in bytes


def _flax_leaf(arr: np.ndarray):
    """An array as flax packs it: extension type 1, or the chunked dict of
    such extensions for an array above 1 GiB."""
    def ext(a):
        return _msgpack.ExtType(1, _msgpack.pack(
            (list(a.shape), a.dtype.name, a.tobytes("C"))))
    if arr.nbytes <= _FLAX_CHUNK:
        return ext(arr)
    flat = arr.reshape(-1)
    per = max(1, _FLAX_CHUNK // arr.dtype.itemsize)
    chunks = [flat[i:i + per] for i in range(0, flat.size, per)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): ext(c) for i, c in enumerate(chunks)}}


def write_flax_msgpack(path, tree: Dict[str, Any]) -> None:
    """Write a tree of numpy arrays as flax's `to_bytes` does."""
    def leaves(t):
        return ({k: leaves(v) for k, v in t.items()} if isinstance(t, dict)
                else _flax_leaf(np.ascontiguousarray(t)))
    Path(path).write_bytes(_msgpack.pack(leaves(tree)))


def save_pretrained(save_dir, state_dict: Dict[str, torch.Tensor],
                    config: GenieConfig) -> None:
    """The JAX package's `save_pretrained` layout: `config.json` and
    `params.msgpack` (flax's layout, scan or unrolled by
    `config.scan_layers`), from a reference-named state dict."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    config.save_pretrained(save_dir / "config.json")
    write_flax_msgpack(save_dir / "params.msgpack",
                       params_to_jax(state_dict, config))


def save_pretrained_torch(save_dir, state_dict: Dict[str, torch.Tensor],
                          config: GenieConfig) -> None:
    """The reference layout: `config.json` and `model.safetensors` under the
    reference's names, fp32, which the reference's
    `STMaskGIT.from_pretrained` and the JAX package's
    `load_torch_checkpoint` read."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    config.save_pretrained(save_dir / "config.json")
    write_safetensors(save_dir / "model.safetensors", {
        k: v.float() if v.is_floating_point() else v
        for k, v in state_dict.items()})


def load_pretrained(save_dir) -> Tuple[Dict[str, torch.Tensor], GenieConfig]:
    """A JAX `save_pretrained` directory -> (state dict, config)."""
    save_dir = Path(save_dir)
    config = GenieConfig.from_pretrained(save_dir / "config.json")
    tree = read_flax_msgpack(save_dir / "params.msgpack")
    if "params" in tree:
        tree = tree["params"]
    return params_from_jax(tree, config), config


# ---------------------------------------------------------------------------
# the full training state
# ---------------------------------------------------------------------------

_ADAMW_KEYS = ("exp_avg", "exp_avg_sq", "step")


def _named_optimizer_params(state) -> Dict[str, torch.Tensor]:
    """The optimizer's parameters by the names they are saved under: the
    model's, with the rank's share appended to a split one's."""
    from tpu1x_torch.parallel.sharding import mesh_of, unwrap
    from tpu1x_torch.parallel.tensor import is_split
    m = mesh_of(state.model)
    names = {id(p): n + (f"/tp{m.model_index}of{m.tp}"
                         if m.tp > 1 and is_split(n) else "")
             for n, p in unwrap(state.model).named_parameters()}
    return {names[id(p)]: p for p in state.optimizer.params}


def _saved_tp(keys) -> int:
    """The tensor parallelism a checkpoint's keys were saved at."""
    for k in keys:
        if (m := re.search(r"/tp\d+of(\d+)$", k)):
            return int(m.group(1))
    return 1


def _state_tensors(state, keys: Optional[set] = None) -> Dict[str, Any]:
    """The training state as one flat dict of tensors, by the names it is
    saved under; the parameters and moments are the live tensors (DTensors
    under FSDP2), so that a load writes into them. With `keys` (a saved
    checkpoint's), AdamW moments and the running mean that the live state
    lacks are allocated to be loaded into."""
    opt = state.optimizer
    named = _named_optimizer_params(state)
    out: Dict[str, Any] = {f"model/{n}": p.detach() for n, p in named.items()}
    for i, (n, p) in enumerate(named.items()):
        st = opt.adamw.state[p]
        if not st and keys is not None and f"adamw/{n}/step" in keys:
            st.update(step=torch.zeros((), dtype=torch.float32),
                      exp_avg=torch.zeros_like(p.detach()),
                      exp_avg_sq=torch.zeros_like(p.detach()))
        for k in _ADAMW_KEYS if st else ():
            out[f"adamw/{n}/{k}"] = st[k]
    if keys is not None and opt._mean is None and any(
            k.startswith("mean/") for k in keys):
        opt._mean = [torch.zeros_like(p.detach()) for p in named.values()]
    if opt._mean is not None:
        out.update({f"mean/{n}": m for n, m in zip(named, opt._mean)})
    out["counters"] = torch.tensor([state.step, opt.updates, opt.micro],
                                   dtype=torch.int64)
    out["generator"] = state.generator.get_state()
    if state.dropout_generator is not None:  # a rank's own
        out[f"dropout_generator/{_rank()}"] = \
            state.dropout_generator.get_state()
    return out


def _rank() -> int:
    from tpu1x_torch.parallel.mesh import process_index
    return process_index()


class Checkpointer:
    """The full training state under `{output_dir}/{name}`, through
    `torch.distributed.checkpoint`: every rank calls `save` and `restore`,
    and under FSDP2 each writes and reads its own shards (no gather of the
    whole state). `save` returns once the state is copied to host memory
    and writes in the background; the next `save`, `wait_until_finished`
    or `close` waits for the write, so at most one step of training
    overlaps it. `restore` loads into the live state in place, bit for bit.
    """

    def __init__(self, output_dir):
        self.output_dir = Path(output_dir).resolve()
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self._pending = None
        # a group of its own, so that the background write's collectives
        # never interleave with the training's on the same group (every
        # rank makes its Checkpointer at the same point)
        import torch.distributed as dist
        self._group = (dist.new_group(backend="gloo")
                       if dist.is_initialized() else None)

    def save(self, state, name: str, wait: bool = False) -> Path:
        import torch.distributed.checkpoint as dcp
        path = self.output_dir / name
        self.wait_until_finished()
        path.mkdir(parents=True, exist_ok=True)
        self._pending = dcp.async_save(_state_tensors(state),
                                       checkpoint_id=str(path),
                                       process_group=self._group)
        if wait:
            self.wait_until_finished()
        return path

    def restore(self, name: str, state):
        """Load `{output_dir}/{name}` into `state` (a `TrainState` whose
        model and optimizer are built and, for FSDP2 and tensor
        parallelism, sharded as when it was saved, over as many ranks:
        `make_train_step`'s, which holds the ranks' dropout generators) and
        return it with its step. Raises, naming both layouts, where the
        checkpoint was saved at another tensor parallelism."""
        import torch.distributed.checkpoint as dcp
        path = Path(name) if Path(name).is_absolute() else \
            self.output_dir / name
        self.wait_until_finished()
        keys = set(dcp.FileSystemReader(str(path)).read_metadata()
                   .state_dict_metadata)
        from tpu1x_torch.parallel.sharding import mesh_of
        saved, live = _saved_tp(keys), mesh_of(state.model).tp
        if saved != live:
            raise ValueError(
                f"{path} holds a state split over a model axis of {saved} "
                f"(--tp {saved}); this run splits it over {live} (--tp "
                f"{live}). Restore at --tp {saved}, or export the whole "
                f"weights and warm-start from them")
        target = _state_tensors(state, keys)
        missing = sorted(set(target) - keys)
        if missing:
            raise ValueError(f"{path} lacks {missing[:5]}: a checkpoint of "
                             f"another model or optimizer")
        with torch.no_grad():
            dcp.load(target, checkpoint_id=str(path),
                     process_group=self._group)
        step, updates, micro = (int(v) for v in target["counters"])
        opt = state.optimizer
        opt.updates, opt.micro = updates, micro
        if micro == 0:
            opt._mean = None
        state.step = step
        state.generator.set_state(target["generator"])
        if state.dropout_generator is not None:
            state.dropout_generator.set_state(
                target[f"dropout_generator/{_rank()}"])
        return state

    def wait_until_finished(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        self.wait_until_finished()

    def latest_step(self) -> Optional[int]:
        steps = [int(m.group(1)) for p in self.output_dir.iterdir()
                 if (m := re.fullmatch(r"step_(\d+)", p.name))
                 and (p / ".metadata").exists()]
        return max(steps) if steps else None
