"""Host-side sharded input pipeline with device prefetch.

Replaces the reference's ``tf.data.TFRecordDataset → map(parse) → batch →
shuffle → prefetch → repeat`` input_fn (fm/fm.py:106-112 and clones) and its
C++ TFRecord reader threads with:

- `ShardSource`: epoch iteration over npz shard files — shard-order shuffle
  + in-shard row shuffle per epoch (superset of the reference's
  1000-element shuffle buffer), fixed-size batches with a carry buffer so
  every batch has a static shape (one compiled step for the whole run),
  remainder dropped at epoch end like ``drop_remainder``.
- `device_prefetch`: a background thread that stages the next host batches
  onto device with the mesh's data sharding (double buffering replaces
  ``prefetch(1000)``; transfers overlap the running step).
- per-host shard assignment via `recsys.core.mesh.host_shard_of`
  (replaces per-process file lists, deepfm/deepfm.py:188-194).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import jax
import numpy as np

from recsys.core.mesh import MeshEnv


class ShardSource:
    """Iterates fixed-size batches over a set of npz shards, forever or for
    a bounded number of epochs."""

    def __init__(
        self,
        shard_paths: list[str],
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        num_epochs: int = -1,
        keys: tuple[str, ...] | None = None,
        cache: bool = True,
        cache_bytes_limit: int = 8 << 30,
    ):
        if not shard_paths:
            raise ValueError("no shards")
        self.shard_paths = list(shard_paths)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_epochs = num_epochs
        self.keys = keys
        self.cache = cache
        self.cache_bytes_limit = cache_bytes_limit
        self._cache: dict[int, dict[str, np.ndarray]] = {}
        self._cache_bytes = 0

    def _load_shard(self, si: int) -> dict[str, np.ndarray]:
        cached = self._cache.get(si)
        if cached is not None:
            return cached
        with np.load(self.shard_paths[si]) as z:
            keys = self.keys or tuple(z.files)
            data = {k: z[k] for k in keys}
        if self.cache:
            nbytes = sum(v.nbytes for v in data.values())
            if self._cache_bytes + nbytes <= self.cache_bytes_limit:
                self._cache[si] = data
                self._cache_bytes += nbytes
        return data

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        epoch = 0
        while self.num_epochs < 0 or epoch < self.num_epochs:
            rng = np.random.default_rng([self.seed, epoch])
            order = np.arange(len(self.shard_paths))
            if self.shuffle:
                rng.shuffle(order)
            carry: dict[str, np.ndarray] | None = None
            for si in order:
                data = self._load_shard(int(si))
                n = len(next(iter(data.values())))
                if self.shuffle:
                    from recsys.data import native
                    perm = rng.permutation(n)
                    data = {k: native.gather_rows(v, perm)
                            for k, v in data.items()}
                if carry is not None:
                    data = {
                        k: np.concatenate([carry[k], v]) for k, v in data.items()
                    }
                    n = len(next(iter(data.values())))
                nb = n // self.batch_size
                for b in range(nb):
                    lo = b * self.batch_size
                    yield {
                        k: v[lo:lo + self.batch_size] for k, v in data.items()
                    }
                rem = n - nb * self.batch_size
                carry = (
                    {k: v[n - rem:] for k, v in data.items()} if rem else None
                )
            epoch += 1


def device_prefetch(
    host_iter: Iterator[dict[str, np.ndarray]],
    env: MeshEnv,
    depth: int = 2,
    axes_fn=None,
) -> Iterator[dict[str, jax.Array]]:
    """Stage host batches onto device asynchronously with the data sharding.

    Each array goes up with leading-dim 'data' sharding (override per-array
    with ``axes_fn(value) -> axes list``, e.g. ``[None, 'data']`` for
    [K, B]-stacked scan inputs); transfers for batch k+1 overlap the
    computation of batch k. An exception raised while generating or
    transferring a batch is re-raised here, in the consumer.
    """
    shardings: dict[str, jax.sharding.NamedSharding] = {}
    if axes_fn is None:
        axes_fn = lambda v: ["data"] + [None] * (v.ndim - 1)
    multiproc = jax.process_count() > 1
    local_mesh_shape = env.mesh.local_mesh.shape if multiproc else None

    def put(batch: dict[str, np.ndarray]) -> dict[str, jax.Array]:
        out = {}
        for k, v in batch.items():
            axes = axes_fn(v)
            sh = shardings.get(k)
            if sh is None:
                sh = env.spec(*axes)
                shardings[k] = sh
            if multiproc:
                # each process stages its own slice of the global batch
                # (its file shard); a dim sharded over a mesh axis spanning
                # S processes is S× larger globally
                gshape = list(v.shape)
                for d, ax in enumerate(axes):
                    if ax is not None:
                        span = env.mesh.shape[ax] // local_mesh_shape[ax]
                        gshape[d] *= span
                out[k] = jax.make_array_from_process_local_data(
                    sh, v, tuple(gshape))
            else:
                out[k] = jax.device_put(v, sh)
        return out

    q: queue.Queue = queue.Queue(maxsize=depth)
    qh: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()

    # two-stage pipeline: host batch generation (shard IO + shuffle +
    # stacking) and the host→device transfer run in separate threads, so
    # transfer of stack k overlaps generation of stack k+1. A producer's
    # exception travels down the queues in place of _END.
    def worker_gen():
        end = _END
        try:
            for batch in host_iter:
                qh.put(batch)
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            end = e
        finally:
            qh.put(end)

    def worker_put():
        while True:
            item = qh.get()
            if item is _END or isinstance(item, BaseException):
                q.put(item)
                return
            try:
                q.put(put(item))
            except BaseException as e:  # noqa: BLE001 — re-raised by consumer
                q.put(e)
                return

    threading.Thread(target=worker_gen, daemon=True).start()
    threading.Thread(target=worker_put, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
