"""Host-side synthetic poses, batching and prefetch (copy of the host numpy
code of probpose_pytorch_tpu/data/pipeline.py, which the port cannot
import: the JAX package's `__init__` pulls in jax).

Samples are numpy; Trainer.fit moves each batch to the model's device.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Any, Iterator, Sequence

import numpy as np

__all__ = ["SyntheticPoseDataset", "batch_iterator", "Prefetcher"]


class SyntheticPoseDataset:
    """Procedural pose dataset: random blob "limbs" rendered at keypoint
    locations. Deterministic per (seed, index), and the same samples as the
    JAX package's dataset of the same name."""

    def __init__(
        self,
        size: int,
        input_size: tuple[int, int] = (256, 192),
        num_keypoints: int = 17,
        seed: int = 0,
    ):
        self.size = size
        self.input_size = input_size
        self.num_keypoints = num_keypoints
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        H, W = self.input_size
        K = self.num_keypoints
        rng = np.random.default_rng((self.seed, idx))
        kpts = rng.uniform([-0.1 * W, -0.1 * H], [1.1 * W, 1.1 * H], (K, 2))
        visible = (rng.random(K) > 0.15).astype(np.float32)
        visibility = np.where(
            visible > 0, (rng.random(K) > 0.3).astype(np.float32), 0.0
        )
        img = (rng.random((H, W, 3)) * 60).astype(np.float32)
        ys, xs = np.mgrid[0:H, 0:W]
        for k in range(K):
            if visible[k] < 0.5:
                continue
            d2 = (xs - kpts[k, 0]) ** 2 + (ys - kpts[k, 1]) ** 2
            img += (
                rng.random(3)[None, None]
                * 195.0
                * np.exp(-d2 / (2 * 16.0))[..., None]
            )
        return dict(
            image=np.clip(img, 0, 255).astype(np.uint8),
            keypoints=kpts.astype(np.float32),
            keypoints_visible=visible,
            keypoints_visibility=visibility,
        )


def _collate(samples: Sequence[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0].keys()}


def batch_iterator(
    dataset: Any,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
    num_workers: int = 4,
    epoch: int = 0,
    process_index: int | None = None,
    process_count: int | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield collated numpy batches. Datasets with `get_batch(indices)`
    (CachedCropDataset, the COCO and YOLO loaders) are read a batch at a
    time; other samples load in a thread pool. Shuffling draws the
    permutation from the (seed, epoch) generator, as the JAX iterator does.

    Several processes: with (process_index, process_count) `batch_size`
    stays the global batch, every process draws the same permutation and
    yields its contiguous slice of each global batch (on a mesh: the data
    coordinate and the data axis's size, train/loop.py `local_batches`)."""
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(idx)
    ends = len(idx) // batch_size * batch_size
    groups = [idx[i : i + batch_size] for i in range(0, ends, batch_size)]
    if not drop_last and ends < len(idx):
        groups.append(idx[ends:])
    if process_count is not None and process_count > 1:
        if process_index is None:
            raise ValueError("process_index required with process_count")
        if batch_size % process_count != 0:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"process_count {process_count}")
        local = batch_size // process_count
        groups = [g[process_index * local:(process_index + 1) * local] for g in groups
                  if len(g) == batch_size]  # a ragged tail does not split evenly
    if hasattr(dataset, "get_batch"):
        for g in groups:
            yield dataset.get_batch(g)
        return
    if num_workers <= 1:
        for g in groups:
            yield _collate([dataset[int(i)] for i in g])
        return
    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        for g in groups:
            yield _collate(list(pool.map(dataset.__getitem__, (int(i) for i in g))))


class Prefetcher:
    """An iterator run ahead by a background thread into a queue of `depth`
    items, so host data preparation overlaps device work. The consumer
    sees the iterator's exception where it was raised. `close` stops the
    thread (and closes the iterator) when the consumer leaves early."""

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: BaseException | None = None
        self._stop = threading.Event()

        def run():
            try:
                for item in iterator:
                    if not self._put(item):
                        break
            except BaseException as e:  # handed to the consumer
                self._err = e
            finally:
                close = getattr(iterator, "close", None)
                if close is not None:
                    close()
                self._put(self._done)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self, timeout: float = 60.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
