"""Worker for the 2-process distributed EM test (launched by pytest).

Each process owns 4 virtual CPU devices; the global mesh spans 8 devices
across both processes. Both processes construct the same logical inputs;
`put_global` places only the shards each process can address, and the
M-step psum crosses the process boundary. Process 0 writes the learnt
addition for the test to compare against the single-process result.

Usage: python multiprocess_worker.py <process_id> <coordinator_port> <out_dir>
"""
import os
import sys
from pathlib import Path

process_id = int(sys.argv[1])
port = int(sys.argv[2])
out_dir = Path(sys.argv[3])

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=2,
    process_id=process_id,
)

import numpy as np

from demuxalot_tpu.ops import likelihood as L
from demuxalot_tpu.parallel.mesh import make_mesh, to_host
from demuxalot_tpu.parallel.sharded import ShardedDemultiplexer
from demuxalot_tpu.sim import synthesize_device_workload

assert jax.device_count() == 8, jax.devices()
assert jax.local_device_count() == 4

N_B, N_D, N_S, CPB = 1024, 4, 64, 8
betas, v2s, vid, cb, q, _ = synthesize_device_workload(N_B, N_D, N_S, CPB, seed=11)
mixing, _names = L.pseudogenotype_mixing([f"D{i}" for i in range(N_D)], 0.25)
pen = L.doublet_penalties(N_D, 0.25)
n_variants, n_genotypes = betas.shape

sh = ShardedDemultiplexer(make_mesh())  # global 8-device mesh


# shard-local data path: this process hands over ONLY the rows of its own
# barcode ranges — the full call table is never materialized here, which is
# the property that keeps host memory flat on multi-host meshes
per_shard = sh._barcodes_per_shard(N_B)
my_rows = np.isin(cb // per_shard, sh._local_shard_ids())
assert 0 < my_rows.sum() < len(cb), "each process should hold a strict subset"
from demuxalot_tpu.parallel.sharded import ColumnDataset

packed = ColumnDataset(cb[my_rows], vid[my_rows], q[my_rows])

entry_e, entry_m = sh._shard_inputs(packed, N_B, build_mstep=True)
betas_r, v2s_r, zero_r, one_r = sh._replicate(betas, v2s, np.float32(0.0), np.float32(1.0))
estep, eargs = sh._make_estep(entry_e, mixing, pen, N_S, 0.01)
mstep, margs = sh._make_mstep(entry_m, n_variants, n_genotypes)

logits, probs = estep(betas_r, zero_r, v2s_r, *eargs)
addition = mstep(probs, one_r, *margs)

logits_np = to_host(logits)[:N_B]
addition_np = to_host(addition)

if process_id == 0:
    np.savez(out_dir / "result.npz", logits=logits_np, addition=addition_np)
print(f"process {process_id} done", flush=True)
