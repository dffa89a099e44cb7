"""Device mesh + distributed initialization.

Replacement for the reference's two-line distribution setup
(``tf.distribute.MirroredStrategy()`` — deepfm/deepfm.py:159-169 and clones,
SURVEY §5.8): a single `jax.sharding.Mesh` with axes ``('data', 'model')``.

- ``data``: batch (pure DP; gradients psum, which XLA lowers to an NCCL
  all-reduce, as MirroredStrategy's).
- ``model``: embedding-table row sharding (the CTR-natural model parallelism;
  the dense towers are tiny and stay replicated).

Multi-host initialization goes through :func:`distributed_init`
(``jax.distributed.initialize``); collectives then run over NCCL: NVLink
between the GPUs of one host, the network across hosts. Every GPU of a host
reaches every other at the same rate, so the mesh shape follows the
algorithm alone.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from recsys.core.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshEnv:
    """A constructed mesh plus the canonical shardings used by the framework."""

    mesh: Mesh

    @property
    def data_sharding(self) -> NamedSharding:
        """Batch tensors: leading dim split over 'data' (and nothing else)."""
        return NamedSharding(self.mesh, P(DATA_AXIS))

    @property
    def batch2d_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(DATA_AXIS, None))

    @property
    def replicated_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    @property
    def row_sharding(self) -> NamedSharding:
        """Embedding tables: rows split over 'model'."""
        return NamedSharding(self.mesh, P(MODEL_AXIS, None))

    @property
    def num_data(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def num_model(self) -> int:
        return self.mesh.shape[MODEL_AXIS]

    def spec(self, *axes: str | None) -> NamedSharding:
        return NamedSharding(self.mesh, P(*axes))


def make_mesh(cfg: MeshConfig = MeshConfig(), devices=None) -> MeshEnv:
    """Build the 2-D ('data','model') mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    model = max(1, cfg.model_axis)
    data = cfg.data_axis if cfg.data_axis > 0 else n // model
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} does not cover {n} devices"
        )
    dev_array = np.asarray(devices).reshape(data, model)
    return MeshEnv(mesh=Mesh(dev_array, cfg.axis_names))


def make_virtual_mesh(n_devices: int, model_axis: int = 1) -> MeshEnv:
    """Mesh over however many devices exist, for tests/dryrun.

    Tests run with ``XLA_FLAGS=--xla_force_host_platform_device_count=N``
    (SURVEY §4c — the JAX analog of a fake backend).
    """
    devices = jax.devices()[:n_devices]
    cfg = MeshConfig(data_axis=len(devices) // model_axis, model_axis=model_axis)
    return make_mesh(cfg, devices)


def distributed_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up (replaces implicit single-host MirroredStrategy).

    No-op when single-process (the common test path). On a pod slice, every
    host calls this before touching devices.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("RECSYS_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_shard_of(files: list, process_index: int | None = None,
                  process_count: int | None = None) -> list:
    """Per-host file-shard assignment (replaces per-process TFRecord lists,
    deepfm/deepfm.py:188-194): host i takes files i, i+P, i+2P, ..."""
    if process_index is None:
        process_index = jax.process_index()
    if process_count is None:
        process_count = jax.process_count()
    return files[process_index::process_count]
