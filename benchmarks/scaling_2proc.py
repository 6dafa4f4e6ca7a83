"""Two-process distributed EM timing (multi-host-style weak scaling).

Launches two OS processes with 4 virtual CPU devices each, joined through
jax.distributed into one 8-device mesh, and times EM iterations with the
shard-local data path — the same machinery a multi-host cluster uses. Compare
against the single-process 8-device point from benchmarks/scaling.py: the
delta is the cross-process collective + dispatch overhead.

Usage: python benchmarks/scaling_2proc.py            (prints one JSON line)
"""
import json
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

WORKER = r'''
import os, sys, time, json
process_id = int(sys.argv[1]); port = int(sys.argv[2])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[3])
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}", num_processes=2, process_id=process_id)
import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PSpec
from demuxalot_tpu.ops import likelihood as L
from demuxalot_tpu.parallel.mesh import BARCODE_AXIS, make_mesh
from demuxalot_tpu.parallel.sharded import ColumnDataset, ShardedDemultiplexer
from demuxalot_tpu.sim import synthesize_device_workload

N_B, N_D, N_S, CPB = 8192 * 8, 16, 16384, 32
betas, v2s, vid, cb, q, _ = synthesize_device_workload(N_B, N_D, N_S, CPB, seed=0)
mixing, _n = L.pseudogenotype_mixing([f"D{i:02}" for i in range(N_D)], 0.0)
pen = L.doublet_penalties(N_D, 0.0)
n_variants, n_genotypes = betas.shape

sh = ShardedDemultiplexer(make_mesh())

# shard-local: this process only ever holds its own barcode ranges
per_shard = sh._barcodes_per_shard(N_B)
mine = np.isin(cb // per_shard, sh._local_shard_ids())
packed = ColumnDataset(cb[mine], vid[mine], q[mine])

entry_e, entry_m = sh._shard_inputs(packed, N_B, build_mstep=True)
betas_r, v2s_r, one_r = sh._replicate(betas, v2s, np.float32(1.0))
estep, eargs = sh._make_estep(entry_e, mixing, pen, N_S, 0.01, max_per_snp=2)
mstep, margs = sh._make_mstep(entry_m, n_variants, n_genotypes)

def em(addition):
    _lg, probs = estep(betas_r, addition, v2s_r, *eargs)
    return mstep(probs, one_r, *margs)

add = em(sh._replicate(np.zeros_like(betas))[0])
add.block_until_ready()
times = []
for _ in range(5):
    t0 = time.perf_counter()
    add = em(add)
    add.block_until_ready()
    times.append(time.perf_counter() - t0)

# psum payload sweep: the iteration's one collective at a
# range of [V, D] partial sizes, up to PMBC's real payload (~84 MB), so the
# cross-process overhead can be modeled as a curve instead of one constant
psum_only = jax.jit(jax.shard_map(
    lambda x: jax.lax.psum(x, BARCODE_AXIS),
    mesh=sh.mesh, in_specs=PSpec(), out_specs=PSpec(), check_vma=False,
))
sweep = []
for target_bytes in (1 << 20, 4 << 20, 16 << 20, 64 << 20, 84 * (1 << 20)):
    v_rows = max(1, target_bytes // (N_D * 4))
    x = sh._replicate(np.ones((v_rows, N_D), np.float32))[0]
    psum_only(x).block_until_ready()  # compile
    best = None
    for _ in range(5):
        t0 = time.perf_counter()
        psum_only(x).block_until_ready()
        dt = time.perf_counter() - t0
        best = dt if best is None or dt < best else best
    sweep.append({"bytes": int(v_rows * N_D * 4), "psum_s": round(best, 5)})

if process_id == 0:
    best = min(times)
    print("RESULT " + json.dumps({
        "processes": 2, "devices": 8, "n_barcodes": N_B,
        "em_iteration_s": round(best, 4),
        "barcodes_per_s": round(N_B / best, 1),
        "psum_sweep": sweep,
    }), flush=True)
'''


def main():
    repo = str(Path(__file__).resolve().parent.parent)
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    # workers are interdependent (shared collectives), so their outputs go
    # to files — draining one worker's pipe while the other blocks on a
    # collective would deadlock until the timeout otherwise
    with tempfile.TemporaryDirectory() as tmp:
        logs = [Path(tmp) / f"worker{pid}.log" for pid in range(2)]
        handles = [open(log, "wb") for log in logs]
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", WORKER, str(pid), str(port), repo],
                stdout=h, stderr=subprocess.STDOUT,
            )
            for pid, h in zip(range(2), handles)
        ]
        try:
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for h in handles:
                h.close()
        outputs = [log.read_text(errors="replace") for log in logs]
    for p, out in zip(procs, outputs):
        if p.returncode != 0:
            print(out[-2000:], file=sys.stderr)
            raise SystemExit(f"worker failed rc={p.returncode}")
    for out in outputs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                print(line[len("RESULT "):])
                return
    raise SystemExit("no RESULT line produced")


if __name__ == "__main__":
    main()
