"""Device mesh construction and sharding helpers.

The reference's only parallelism is single-node multiprocessing with
Manager-list IPC (``BatchPreprocess.py:157,215-225``,
``PoseEstimation.py:214-228``).  The device-level counterpart is a
``jax.sharding.Mesh`` with named axes:

* ``"data"`` — frame-level data parallelism (the analog of the reference's
  10-process frame sharding);
* ``"model"`` — optional tensor parallelism over model feature dimensions
  (unused at the reference's model sizes but wired for scale).

Multi-host bring-up goes through ``initialize_distributed`` -> one global
mesh over all devices.  The mesh is a plain reshape of the device list:
every GPU of a host reaches every other over NVLink at the same rate, so
no axis order is preferred.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_data is None:
        n_data = n // n_model
    assert n_data * n_model <= n, (n_data, n_model, n)
    arr = np.array(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(arr, axis_names=("data", "model"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (frame/batch) axis over the data axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None):
    """Multi-host initialization (``jax.distributed``).  The reference has no
    multi-node capability at all (SURVEY.md section 5); single-process setups
    return immediately."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
