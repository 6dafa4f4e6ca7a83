"""True multi-process (multi-host-style) distributed execution test.

Launches two OS processes, each with 4 virtual CPU devices, joined through
jax.distributed into one 8-device mesh. The EM E-step + psum'd M-step must
reproduce the single-process result — this exercises exactly the machinery
a multi-host cluster uses (process-spanning mesh, cross-process collectives,
global array placement).
"""
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

WORKER = Path(__file__).resolve().parent / "multiprocess_worker.py"


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_em(tmp_path):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outputs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

    result = np.load(tmp_path / "result.npz")

    # single-process reference on the plain 8-device mesh
    from demuxalot_tpu.ops import likelihood as L
    from demuxalot_tpu.parallel.mesh import make_mesh
    from demuxalot_tpu.parallel.sharded import ShardedDemultiplexer
    from demuxalot_tpu.sim import synthesize_device_workload

    N_B, N_D, N_S, CPB = 1024, 4, 64, 8
    np.random.seed(0)
    betas, v2s, vid, cb, q, _ = synthesize_device_workload(N_B, N_D, N_S, CPB, seed=11)
    mixing, _names = L.pseudogenotype_mixing([f"D{i}" for i in range(N_D)], 0.25)
    pen = L.doublet_penalties(N_D, 0.25)
    n_variants, n_genotypes = betas.shape

    sh = ShardedDemultiplexer(make_mesh())
    from demuxalot_tpu.parallel.sharded import ColumnDataset

    packed = ColumnDataset(cb, vid, q)
    entry_e, entry_m = sh._shard_inputs(packed, N_B, build_mstep=True)
    betas_r, v2s_r, zero_r, one_r = sh._replicate(
        betas, v2s, np.float32(0.0), np.float32(1.0)
    )
    estep, eargs = sh._make_estep(entry_e, mixing, pen, N_S, 0.01)
    mstep, margs = sh._make_mstep(entry_m, n_variants, n_genotypes)
    logits, probs = estep(betas_r, zero_r, v2s_r, *eargs)
    addition = mstep(probs, one_r, *margs)

    np.testing.assert_allclose(result["logits"], np.asarray(logits)[:N_B], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(result["addition"], np.asarray(addition), rtol=1e-5, atol=1e-6)
