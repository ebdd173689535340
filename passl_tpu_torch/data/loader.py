# Copied from passl_tpu/data/loader.py; the port keeps its own copy and imports nothing of passl_tpu.
# One change beyond the imports: the prefetch thread of `DataLoader.__iter__` stops and is
# joined when its consumer stops reading early (a loop that ends at max_train_step, an eval
# that breaks, a closed iterator); in the JAX package's loader it stays blocked on a full
# queue until the process exits.
"""Host data loading: samplers, collate, multiprocess prefetch loader.

Capability parity with reference `passl/data/__init__.py:25-83`
(build_dataloader: dataset + DistributedBatchSampler + paddle.io
DataLoader with N CPU workers + batch collate) and
`passl/data/sampler/repeatedaug_sampler.py:25-78`.

TPU-native shape: ONE process per host feeds the *global* batch for its
addressable shard; `jax.make_array_from_process_local_data` assembles
the sharded global array (replacing DistributedBatchSampler's per-rank
slicing + DALI). Workers are a multiprocessing pool doing decode+aug;
a background thread keeps `prefetch` batches in flight so the device
never waits on the host (SURVEY §7 hard part 6).
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np


def default_collate(batch: Sequence[Any]):
    """Stack samples: tuples → tuple of stacks, lists (multi-crop) →
    list of stacks, dicts → dict of stacks."""
    first = batch[0]
    if isinstance(first, (tuple,)):
        return tuple(default_collate([b[i] for b in batch]) for i in range(len(first)))
    if isinstance(first, list):
        return [default_collate([b[i] for b in batch]) for i in range(len(first))]
    if isinstance(first, dict):
        return {k: default_collate([b[k] for b in batch]) for k in first}
    if isinstance(first, (int, np.integer)):
        return np.asarray(batch, np.int32)
    if isinstance(first, (float, np.floating)):
        return np.asarray(batch, np.float32)
    return np.stack([np.asarray(b) for b in batch])


class DistributedBatchSampler:
    """Epoch-shuffled batch index sampler over this process's shard.

    With P host processes, process p owns indices p::P (padded to equal
    length like the reference's DistributedBatchSampler so every process
    yields the same number of batches)."""

    def __init__(
        self,
        dataset_len: int,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_replicas: int = 1,
        rank: int = 0,
    ):
        self.dataset_len = dataset_len
        self.batch_size = batch_size  # per-process batch size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(dataset_len / num_replicas))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        if self.shuffle:
            g = np.random.RandomState(self.seed + self.epoch)
            idx = g.permutation(self.dataset_len)
        else:
            idx = np.arange(self.dataset_len)
        total = self.num_samples * self.num_replicas
        if total > len(idx):  # pad by wrapping (reference padding semantics)
            idx = np.concatenate([idx, idx[: total - len(idx)]])
        return idx[self.rank : total : self.num_replicas]

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = self._indices()
        n_full = len(idx) // self.batch_size
        for i in range(n_full):
            yield idx[i * self.batch_size : (i + 1) * self.batch_size]
        if not self.drop_last and n_full * self.batch_size < len(idx):
            yield idx[n_full * self.batch_size :]

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return int(math.ceil(self.num_samples / self.batch_size))


class RepeatedAugSampler(DistributedBatchSampler):
    """3x repeated augmentation (reference repeatedaug_sampler.py:25-78):
    each selected image appears `num_repeats` times in the epoch stream,
    stream truncated to the usual epoch length."""

    def __init__(self, *args, num_repeats: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_repeats = num_repeats

    def _indices(self) -> np.ndarray:
        if self.shuffle:
            g = np.random.RandomState(self.seed + self.epoch)
            idx = g.permutation(self.dataset_len)
        else:
            idx = np.arange(self.dataset_len)
        idx = np.repeat(idx, self.num_repeats)
        total = self.num_samples * self.num_replicas
        if total > len(idx):
            idx = np.concatenate([idx, idx[: total - len(idx)]])
        return idx[self.rank : total : self.num_replicas]


_WORKER_DATASET = None


def _sample_key(seed: int, epoch: int, gpos: int) -> int:
    """Per-sample RNG key: splitmix64 of (seed, epoch, global stream
    position). Keying aug on the sample's position in the (seeded,
    topology-independent) epoch permutation makes host-side augmentation
    deterministic AND invariant to worker count and process topology —
    stronger than the reference's per-worker streams (engine.py:86-89),
    where aug depends on which worker fetched the sample. Repeated-aug
    copies of one image occupy different stream positions, so they still
    receive distinct augmentations."""
    z = (seed & 0xFFFFFFFFFFFFFFFF) * 0x9E3779B97F4A7C15
    z ^= (epoch + 1) * 0xBF58476D1CE4E5B9
    z ^= (gpos + 1) * 0x94D049BB133111EB
    z &= 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0xFFFFFFFFFFFFFFFF


def _seed_ambient(key: int) -> None:
    import random as _random

    _random.seed(key)
    np.random.seed(key & 0x7FFFFFFF)


def _worker_init(dataset, seed: int = 0):
    """Install the dataset in the worker; per-sample reseeding happens
    in `_worker_fetch` (worker identity must not influence aug)."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    _seed_ambient(_sample_key(seed, 0, 0))


def _worker_fetch(args):
    idx, key = args
    _seed_ambient(key)
    return _WORKER_DATASET[idx]


PREFETCH_THREAD = "passl-loader-prefetch"  # the name of DataLoader's prefetch threads


class DataLoader:
    """Iterable of collated numpy batches with worker pool + prefetch."""

    def __init__(
        self,
        dataset,
        batch_sampler: DistributedBatchSampler,
        num_workers: int = 0,
        collate_fn: Callable = default_collate,
        prefetch: int = 2,
        batch_transform: Optional[Callable] = None,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = num_workers
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.batch_transform = batch_transform
        self.seed = seed
        self._pool = None
        self._skip_batches = 0

    def set_epoch(self, epoch: int):
        self.batch_sampler.set_epoch(epoch)

    def set_skip(self, n: int):
        """Skip the first n batches of the NEXT iteration at the index
        level — no fetch/decode of skipped samples (mid-epoch resume)."""
        self._skip_batches = int(n)

    def _get_pool(self):
        if self._pool is None and self.num_workers > 0:
            import multiprocessing as mp

            ctx = mp.get_context("fork")
            self._pool = ctx.Pool(
                self.num_workers, initializer=_worker_init, initargs=(self.dataset, self.seed)
            )
        return self._pool

    def _keys_for(self, local_pos0: int, n: int):
        """Per-sample RNG keys for a batch starting at local stream
        position `local_pos0`. Global stream position of local element
        p is `p * num_replicas + rank` (the sampler's strided layout),
        so keys are identical for the same sample regardless of process
        topology or worker assignment."""
        bs = self.batch_sampler
        epoch = getattr(bs, "epoch", 0)
        rank = getattr(bs, "rank", 0)
        rep = getattr(bs, "num_replicas", 1)
        return [_sample_key(self.seed, epoch, (local_pos0 + j) * rep + rank)
                for j in range(n)]

    def _fetch_batch(self, indices: np.ndarray, local_pos0: int, batch_no: int):
        keys = self._keys_for(local_pos0, len(indices))
        pool = self._get_pool()
        if pool is not None:
            samples = pool.map(_worker_fetch,
                               list(zip((int(i) for i in indices), keys)))
        else:
            samples = []
            for i, key in zip(indices, keys):
                _seed_ambient(key)
                samples.append(self.dataset[int(i)])
        return self._finalize(samples, batch_no)

    def _finalize(self, samples, batch_no: int):
        batch = self.collate_fn(samples)
        if self.batch_transform is not None:
            # batch transforms (mixup/cutmix) draw from the ambient RNG:
            # key them on the (topology-shared) batch number
            epoch = getattr(self.batch_sampler, "epoch", 0)
            _seed_ambient(_sample_key(self.seed ^ 0x5A5A5A5A, epoch, batch_no))
            batch = self.batch_transform(batch)
        return batch

    def _iter_pipelined(self, batches):
        """Per-sample pipelined fetch: up to `prefetch+1` batches of
        per-sample tasks are in flight at once, so workers never idle at
        batch boundaries (a per-batch pool.map barriers every worker on
        the slowest sample — the reference leans on paddle's C++
        DataLoader for the same reason, data/__init__.py:72-80)."""
        import collections

        pool = self._get_pool()
        depth = max(self.prefetch, 1) + 1
        pending = collections.deque()
        it = iter(batches)

        def submit():
            try:
                batch_no, pos0, idxs = next(it)
            except StopIteration:
                return False
            keys = self._keys_for(pos0, len(idxs))
            pending.append((batch_no, [
                pool.apply_async(_worker_fetch, ((int(i), key),))
                for i, key in zip(idxs, keys)]))
            return True

        for _ in range(depth):
            if not submit():
                break
        while pending:
            batch_no, results = pending.popleft()
            samples = [r.get() for r in results]
            submit()
            yield self._finalize(samples, batch_no)

    def __iter__(self):
        # annotate each batch with its number and starting local stream
        # position (drives the per-sample RNG keys; tail batches may be
        # short, so positions are cumulative, not batch_no * batch_size)
        batches = []
        pos = 0
        for bno, idxs in enumerate(self.batch_sampler):
            batches.append((bno, pos, idxs))
            pos += len(idxs)
        if self._skip_batches:
            batches = batches[self._skip_batches:]
            self._skip_batches = 0
        if self.num_workers > 0 and self.prefetch > 0:
            # collate/batch_transform overlap with the next yield via the
            # prefetch thread below; worker decode overlaps via _iter_pipelined
            gen = self._iter_pipelined(batches)
        elif self.prefetch <= 0:
            for bno, pos0, b in batches:
                yield self._fetch_batch(b, pos0, bno)
            return
        else:
            gen = (self._fetch_batch(b, pos0, bno) for bno, pos0, b in batches)

        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = object()
        halt = threading.Event()  # set when the consumer stops reading early

        def producer():
            # a decode/worker failure must FAIL the run, not silently
            # truncate the epoch: ship the exception to the consumer
            try:
                for item in gen:
                    q.put(item)
                    if halt.is_set():
                        return
                q.put(stop)
            except BaseException as exc:  # noqa: BLE001
                q.put(("__loader_error__", exc))

        t = threading.Thread(target=producer, name=PREFETCH_THREAD, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, tuple) and len(item) == 2 \
                        and isinstance(item[0], str) and item[0] == "__loader_error__":
                    t.join()
                    raise RuntimeError("dataloader worker failed") from item[1]
                yield item
        finally:
            # an early stop (GeneratorExit here): free the queue until the
            # producer sees `halt` after its next put, then join it
            halt.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)
            t.join()

    def __len__(self):
        return len(self.batch_sampler)

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None
