"""Memmapped raw token store: the reference dataset's on-disk contract
(README, "Dataset contract").

- `video.bin`: the token ids, memmapped as (num_images, s, s) with the dtype
  of `metadata.json["token_dtype"]` (uint32 by default); `metadata.json`
  holds `num_images`, `s`, `vocab_size`, `hz`.
- A window is `window_size` frames `stride` apart. `filter_interrupts`
  drops windows whose first and last frames have different ids in
  `segment_ids.bin` (int32 per frame); `filter_overlaps` keeps each frame in
  at most one window.
- `actions.bin` (uint16 per frame), where present, gives each frame's
  action id.

Batches are numpy arrays, (B, T, H, W) int32, gathered on the host by the
native runtime (`tpu1x_torch.data.native`); callers move them to the
device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from tpu1x_torch.data import native


class RawTokenDataset:
    """Sliding-window view over a memmapped token stream."""

    def __init__(self, data_dir, window_size: int, stride: int = 1,
                 filter_interrupts: bool = True,
                 filter_overlaps: bool = False):
        data_dir = Path(data_dir)
        with open(data_dir / "metadata.json") as f:
            self.metadata = json.load(f)

        s = self.metadata["s"]
        num_images = self.metadata["num_images"]
        token_dtype = np.dtype(self.metadata.get("token_dtype", "uint32"))
        self.data = np.memmap(data_dir / "video.bin", dtype=token_dtype,
                              mode="r", shape=(num_images, s, s))

        segment_path = data_dir / "segment_ids.bin"
        if segment_path.is_file():
            self.segment_ids = np.memmap(segment_path, dtype=np.int32,
                                         mode="r", shape=(num_images,))
        else:
            self.segment_ids = None
            if filter_interrupts:
                raise NotImplementedError(
                    "Cannot filter interrupted sequences without segment ids.")

        actions_path = data_dir / "actions.bin"
        self.actions = (np.memmap(actions_path, dtype=np.uint16, mode="r",
                                  shape=(num_images,))
                        if actions_path.is_file() else None)

        self.window_size, self.stride = window_size, stride
        self.video_len = (window_size - 1) * stride
        segments = (np.asarray(self.segment_ids)
                    if filter_interrupts and self.segment_ids is not None
                    else None)
        starts = native.build_window_index(segments, len(self.data),
                                           self.video_len)
        if filter_overlaps:
            starts = native.filter_overlaps(starts, window_size, stride,
                                            len(self.data))
        self.valid_start_inds = starts

    def __len__(self) -> int:
        return len(self.valid_start_inds)

    def __getitem__(self, idx: int) -> dict:
        """One flattened example in the reference's form."""
        x = self.get_frames(int(self.valid_start_inds[idx])).reshape(-1)
        return {"input_ids": x, "labels": x.copy(),
                "attention_mask": np.ones_like(x)}

    def _window(self, start: int) -> slice:
        return slice(start, start + self.video_len + 1, self.stride)

    def get_frames(self, start_ind: int) -> np.ndarray:
        """(T, H, W) int32 window starting at frame `start_ind`."""
        return np.asarray(self.data[self._window(start_ind)]).astype(np.int32)

    def get_batch(self, indices: np.ndarray) -> np.ndarray:
        """(B, T, H, W) int32 windows by dataset index."""
        starts = self.valid_start_inds[np.asarray(indices)]
        return native.gather_windows(self.data, starts, self.window_size,
                                     self.stride)

    def get_action_batch(self, indices: np.ndarray) -> Optional[np.ndarray]:
        """(B, T) int32 action ids per frame, or None without actions.bin."""
        if self.actions is None:
            return None
        return np.stack([
            np.asarray(self.actions[self._window(
                int(self.valid_start_inds[i]))]).astype(np.int32)
            for i in np.asarray(indices)])


class ShardedBatchLoader:
    """Batches of a seeded permutation, each process taking its share.

    Every process draws the same permutation of the dataset for an epoch
    (seed + epoch) and takes every `process_count`-th index of each global
    batch from `process_index` on, so the processes split each batch
    without communicating.
    """

    def __init__(self, dataset: RawTokenDataset, global_batch_size: int,
                 process_index: int = 0, process_count: int = 1,
                 seed: int = 0, shuffle: bool = True, drop_last: bool = True,
                 with_actions: bool = False):
        if global_batch_size % process_count:
            raise ValueError(f"global batch {global_batch_size} does not "
                             f"split over {process_count} processes")
        self.dataset = dataset
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // process_count
        self.process_index = process_index
        self.process_count = process_count
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.with_actions = with_actions

    def __len__(self) -> int:
        return len(self.dataset) // self.global_batch_size

    def epoch(self, epoch: int, start_batch: int = 0) -> Iterator[dict]:
        """Yield this process's batches of `epoch`, from batch `start_batch`
        on (to resume): {"tokens": (b, T, H, W) int32[, "actions": (b, T)
        int32]}."""
        n = len(self.dataset)
        order = (np.random.RandomState(self.seed + epoch).permutation(n)
                 if self.shuffle else np.arange(n))
        gb = self.global_batch_size
        num_batches = n // gb if self.drop_last else -(-n // gb)
        for b in range(start_batch, num_batches):
            local = order[b * gb:(b + 1) * gb][
                self.process_index::self.process_count]
            batch = {"tokens": self.dataset.get_batch(local)}
            if self.with_actions:
                actions = self.dataset.get_action_batch(local)
                if actions is not None:
                    batch["actions"] = actions
            yield batch


def write_token_dataset(data_dir, tokens_NHW: np.ndarray, hz: float = 2.0,
                        vocab_size: int = 262144,
                        segment_ids: Optional[np.ndarray] = None,
                        token_dtype: str = "uint32",
                        extra_metadata: Optional[dict] = None) -> None:
    """Write `video.bin` and `metadata.json`, with `segment_ids.bin` where
    given, in the reference's layout."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    tokens_NHW = np.ascontiguousarray(
        np.asarray(tokens_NHW).astype(np.dtype(token_dtype)))
    tokens_NHW.tofile(data_dir / "video.bin")
    metadata = {"num_images": int(tokens_NHW.shape[0]),
                "s": int(tokens_NHW.shape[1]), "vocab_size": int(vocab_size),
                "hz": hz, "token_dtype": token_dtype}
    if extra_metadata:
        metadata.update(extra_metadata)
    with open(data_dir / "metadata.json", "w") as f:
        json.dump(metadata, f)
    if segment_ids is not None:
        np.ascontiguousarray(np.asarray(segment_ids).astype(np.int32)).tofile(
            data_dir / "segment_ids.bin")
