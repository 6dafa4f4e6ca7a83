"""Device mesh helpers for barcode-sharded execution.

The demultiplexing workload is data-parallel over barcodes: call tables and
logits shard on the barcode axis, genotype beta tables replicate, and EM
M-step partials merge with one psum per iteration. A 1-D mesh over all
devices is the right shape at any scale (cards on NVLink, hosts via
jax.distributed over the network).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

BARCODE_AXIS = "barcodes"


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = BARCODE_AXIS) -> Mesh:
    """1-D mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (axis_name,))


def call_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for flat per-call arrays laid out shard-major by barcode range."""
    return NamedSharding(mesh, PartitionSpec(BARCODE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def init_distributed(**kwargs) -> None:
    """Initialize multi-host execution (wraps jax.distributed.initialize).

    Call once per host process before any computation when running on a
    multi-host cluster; single-host usage needs nothing.
    """
    jax.distributed.initialize(**kwargs)


def put_global(x, sharding: NamedSharding):
    """Place a host array onto a (possibly multi-host) sharding.

    Single-process meshes use a plain device_put; on multi-host meshes each
    process contributes the shards it can address. NOTE: on multi-host
    meshes this requires every process to hold the full logical array —
    fine for replicated tables (betas, mixing), wasteful for barcode-
    sharded data. Use :func:`put_row_shards` for the sharded inputs so each
    host only ever materializes its own barcode range.
    """
    if sharding.is_fully_addressable:
        return jax.device_put(x, sharding)
    import numpy as np

    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def local_shard_ids(mesh: Mesh) -> list:
    """Positions along the (1-D) mesh axis owned by this process."""
    me = jax.process_index()
    return [k for k, dev in enumerate(mesh.devices.flat) if dev.process_index == me]


def put_row_shards(local_blocks: dict, sharding: NamedSharding, global_shape: tuple):
    """Assemble a dim-0-sharded global array from process-local blocks.

    ``local_blocks`` maps mesh-axis position -> that shard's rows; a process
    only supplies (and only ever materializes) the blocks for shards its
    own devices hold, so peak host memory is the local share of the data —
    the property that lets multi-host runs load barcode ranges host-locally.
    """
    mesh = sharding.mesh
    devices = list(mesh.devices.flat)
    assert global_shape[0] % len(devices) == 0, (global_shape, len(devices))
    rows = global_shape[0] // len(devices)
    me = jax.process_index()
    singles = []
    for k, dev in enumerate(devices):
        if dev.process_index != me:
            continue
        block = local_blocks[k]
        assert block.shape == (rows,) + tuple(global_shape[1:]), (block.shape, global_shape)
        singles.append(jax.device_put(block, dev))
    return jax.make_array_from_single_device_arrays(global_shape, sharding, singles)


def allreduce_max_dims(values) -> list:
    """Agree on layout dimensions across processes (max per entry).

    Multi-host static shapes (padded chunk counts per shard) must match on
    every process; single-process meshes return the input unchanged.
    """
    import numpy as np

    values = list(values)
    if jax.process_count() == 1:
        return values
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(np.asarray(values, np.int64))
    return np.max(gathered, axis=0).tolist()


def to_host(x):
    """Fetch a device array to host numpy, multi-host safe.

    Replicated or sharded global arrays on non-addressable meshes are
    reassembled via allgather across processes.
    """
    import numpy as np

    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
