"""The port's token data path against the JAX package's, on the CPU.

One synthetic dataset, with several segments and actions, is written by
each package's `write_token_dataset` (the files must be equal) and read by
both `RawTokenDataset`s with the segment and overlap filters on and off:
window starts, single examples, batches, action batches and the epochs of
`ShardedBatchLoader` must be equal. The port's native entry points must
equal their numpy forms and the JAX binding's.
"""

import time

import numpy as np
import pytest

from tpu1x.data import native as jax_native
from tpu1x.data.token_store import RawTokenDataset as JaxDataset
from tpu1x.data.token_store import ShardedBatchLoader as JaxLoader
from tpu1x.data.token_store import write_token_dataset as jax_write
from tpu1x_torch.data import native
from tpu1x_torch.data.token_store import (RawTokenDataset, ShardedBatchLoader,
                                          write_token_dataset)

N_FRAMES, SIDE = 160, 4


@pytest.fixture(scope="module", params=["uint32", "uint16"])
def datasets(request, tmp_path_factory):
    """The same frames written by both packages: (port dir, JAX dir)."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 60000, (N_FRAMES, SIDE, SIDE))
    segments = np.repeat(np.arange(5), [30, 41, 17, 50, 22]).astype(np.int32)
    actions = rng.integers(0, 7, N_FRAMES).astype(np.uint16)
    root = tmp_path_factory.mktemp(f"data_{request.param}")
    dirs = []
    for name, write in (("port", write_token_dataset), ("jax", jax_write)):
        d = root / name
        write(d, frames, hz=10.0, vocab_size=65536, segment_ids=segments,
              token_dtype=request.param, extra_metadata={"note": "synthetic"})
        actions.tofile(d / "actions.bin")
        dirs.append(d)
    return dirs


def test_written_files_equal(datasets):
    port, jax = datasets
    for name in ("video.bin", "metadata.json", "segment_ids.bin"):
        assert (port / name).read_bytes() == (jax / name).read_bytes(), name


@pytest.mark.parametrize("filter_interrupts", [True, False])
@pytest.mark.parametrize("filter_overlaps", [True, False])
@pytest.mark.parametrize("window_size,stride", [(4, 1), (5, 3)])
def test_windows_batches_and_actions_equal(datasets, filter_interrupts,
                                           filter_overlaps, window_size,
                                           stride):
    kw = dict(window_size=window_size, stride=stride,
              filter_interrupts=filter_interrupts,
              filter_overlaps=filter_overlaps)
    got, want = RawTokenDataset(datasets[0], **kw), JaxDataset(datasets[1],
                                                                **kw)
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.valid_start_inds, want.valid_start_inds)
    idx = np.arange(len(got))[::-1]
    batch = got.get_batch(idx)
    assert batch.dtype == np.int32
    assert batch.shape == (len(got), window_size, SIDE, SIDE)
    np.testing.assert_array_equal(batch, want.get_batch(idx))
    np.testing.assert_array_equal(got.get_action_batch(idx),
                                  want.get_action_batch(idx))
    for i in (0, len(got) - 1):
        for key, value in got[i].items():
            np.testing.assert_array_equal(value, want[i][key])
    assert got.metadata == want.metadata


@pytest.mark.parametrize("process_count", [1, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_sharded_loader_epochs_equal(datasets, process_count, shuffle,
                                     drop_last):
    kw = dict(window_size=4, stride=2)
    got_ds, want_ds = RawTokenDataset(datasets[0], **kw), JaxDataset(
        datasets[1], **kw)
    for index in range(process_count):
        lkw = dict(global_batch_size=6, process_index=index,
                   process_count=process_count, seed=3, shuffle=shuffle,
                   drop_last=drop_last, with_actions=True)
        got, want = (ShardedBatchLoader(got_ds, **lkw),
                     JaxLoader(want_ds, **lkw))
        assert len(got) == len(want)
        for epoch, start in ((0, 0), (1, 2)):
            g = list(got.epoch(epoch, start_batch=start))
            w = list(want.epoch(epoch, start_batch=start))
            assert len(g) == len(w) > 0
            for a, b in zip(g, w):
                assert a.keys() == b.keys() == {"tokens", "actions"}
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key])


def test_filter_interrupts_needs_segment_ids(tmp_path):
    write_token_dataset(tmp_path, np.zeros((8, 2, 2)), vocab_size=4)
    with pytest.raises(NotImplementedError):
        RawTokenDataset(tmp_path, window_size=2)
    assert len(RawTokenDataset(tmp_path, window_size=2,
                               filter_interrupts=False)) == 7


def test_native_entry_points_equal_numpy_forms():
    # The JAX package's loader runs `make -C native`, which links
    # native/libtoken_store.so in place, when it finds no library: under
    # xdist another worker's loader may have opened that file half-written
    # ("file too short") and cached the failure. So both loaders' caches are
    # cleared, and the JAX package's load is tried again while the build
    # that another worker may be running finishes (the port's own library is
    # built under another name and renamed into place whole).
    native._lib, native._tried = None, False
    ours = native.have_native()
    for _ in range(120):
        jax_native._lib, jax_native._tried = None, False
        if jax_native.have_native() or not ours:
            break
        time.sleep(0.5)
    assert native.have_native() == jax_native.have_native()
    rng = np.random.default_rng(4)
    seg = np.repeat(np.arange(6), rng.integers(5, 40, 6)).astype(np.int32)
    n = len(seg)
    for segments in (seg, None):
        got = native.build_window_index(segments, n, 7)
        np.testing.assert_array_equal(
            got, native.build_window_index_numpy(segments, n, 7))
        np.testing.assert_array_equal(
            got, jax_native.build_window_index(segments, n, 7))
    starts = np.sort(rng.choice(1000, 300, replace=False)).astype(np.int64)
    for window, stride in ((8, 3), (16, 1), (4, 15)):
        got = native.filter_overlaps(starts, window, stride, 1000)
        np.testing.assert_array_equal(
            got, native.filter_overlaps_numpy(starts, window, stride))
        np.testing.assert_array_equal(
            got, jax_native.filter_overlaps(starts, window, stride, 1000))
    for dtype in (np.uint16, np.uint32):
        data = rng.integers(0, 60000, (64, 4, 4)).astype(dtype)
        idx = np.array([0, 5, 10, 31], dtype=np.int64)
        got = native.gather_windows(data, idx, T=8, stride=3)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(
            got, native.gather_windows_numpy(data, idx, 8, 3))
        np.testing.assert_array_equal(
            got, jax_native.gather_windows(data, idx, 8, 3))
