"""Multi-device demultiplexing: shard the barcode axis over a device mesh.

The sharded engine splits barcodes across every visible accelerator
(replicating the genotype tables) and merges the M-step sufficient
statistics with one psum per EM iteration — the same machinery scales to
multi-host clusters via `init_distributed()` (one call per host before
building the mesh).

This script runs anywhere: on a machine without accelerators it
demonstrates the same code path on a virtual 8-device CPU mesh.

Run:  python examples/4-multi_device_sharded.py
"""
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# no accelerators? fabricate an 8-device CPU mesh BEFORE jax initializes
if "--cpu-mesh" in sys.argv or os.environ.get("JAX_PLATFORMS", "") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count=8".strip()

import jax

if jax.default_backend() == "cpu" and len(jax.devices()) < 2:
    print("only one device visible; re-run with "
          "JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8")
    sys.exit(1)

import numpy as np

from demuxalot_tpu import BarcodeHandler, count_snps
from demuxalot_tpu.parallel import ShardedDemultiplexer, make_mesh
from demuxalot_tpu.sim import generate_bam_file
from demuxalot_tpu.utils import Timer

# --- synthesize an experiment (swap in your own BAM + VCF here) ------------
np.random.seed(0)
tmpdir = tempfile.mkdtemp()
with Timer("synthesize experiment"):
    bam, genotypes, _ids, barcode2donors = generate_bam_file(
        f"{tmpdir}/experiment.bam",
        n_genotypes=8,
        n_barcodes=2000,
        n_reads_per_barcode=40,
        doublets_fraction=0.2,
    )
barcode_handler = BarcodeHandler(list(barcode2donors))

with Timer("count SNP evidence"):
    calls = count_snps(
        bam, genotypes.get_chromosome2positions(), barcode_handler,
        joblib_n_jobs=4, joblib_verbosity=0,
    )

# --- sharded execution ------------------------------------------------------
mesh = make_mesh()  # 1-D mesh over every visible device
print(f"mesh: {mesh.devices.size} devices on backend {jax.default_backend()!r}")
sharded = ShardedDemultiplexer(mesh)

with Timer("sharded EM refinement"):
    learnt, posteriors = sharded.learn_genotypes(
        calls, genotypes, barcode_handler, n_iterations=4
    )

with Timer("sharded posterior inference"):
    logits, probs = sharded.predict_posteriors(
        calls, learnt, barcode_handler, doublet_prior=0.35
    )

assignments = probs.idxmax(axis=1)
correct = np.mean([
    any(d in barcode2donors[bc] for d in assigned.split("+"))
    for bc, assigned in assignments.items()
])
print(f"assignment accuracy vs simulation truth: {correct:.3f}")
print(probs.head())
