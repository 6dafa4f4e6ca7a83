"""Benchmark: E-step, M-step and EM iteration on the local GPU.

Headline metric: barcode×SNP×genotype likelihood evaluations per second on
one card — one evaluation is one (call, pseudo-genotype) term
log(p·(1−q) + q̃) accumulated into a barcode logit, the hot loop of the
reference implementation (demuxalot/demux.py:256-263). The baseline is the
reference's numpy compute style (per-pseudogenotype gather + log + bincount)
measured single-threaded on the host, at 32 donors → 528 pseudo-genotypes.

Times the E-step on XLA (``ops.likelihood``) and through the fused kernel
(``ops.estep_kernel``), the XLA M-step, and one EM iteration (E-step,
softmax, M-step) on each E-step path — warm, each ending in
``block_until_ready``. Roofline floors use the peak table below, keyed by
``device_kind``. Runs only on a GPU; it fails rather than fall back.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

if "--end-to-end" in sys.argv[1:]:
    # product-level pipeline benchmark (BAM -> posteriors, stage-timed,
    # vs a measured reference-style baseline)
    from benchmarks.end_to_end import main as e2e_main

    e2e_main([a for a in sys.argv[1:] if a != "--end-to-end"])
    sys.exit(0)

if "--quality" in sys.argv[1:]:
    # regenerate EVERY quality artifact section and stamp the producing
    # commit (QUALITY.json must never lag the code).
    # Runs the perf-marked reference-parity sweep (noise/semi-supervised/EM
    # parity sections) then the at-scale harness (at_scale section), both
    # of which write their sections into QUALITY.json themselves.
    import subprocess
    import time as _time

    HERE = Path(__file__).resolve().parent
    for cmd in (
        [sys.executable, "-m", "pytest", "-m", "perf", "-x", "-q",
         str(HERE / "tests" / "test_reference_scale.py")],
        [sys.executable, str(HERE / "benchmarks" / "at_scale_quality.py"),
         *[a for a in sys.argv[1:] if a == "--quick"]],
    ):
        print(f"# running: {' '.join(cmd[1:])}", file=sys.stderr, flush=True)
        rc = subprocess.run(cmd, cwd=str(HERE)).returncode
        if rc != 0:
            print(json.dumps({"error": f"quality step failed rc={rc}",
                              "cmd": cmd[1:]}))
            sys.exit(rc)
    quality_path = HERE / "QUALITY.json"
    quality = json.loads(quality_path.read_text())
    commit = subprocess.run(
        ["git", "rev-parse", "HEAD"], cwd=str(HERE),
        capture_output=True, text=True,
    ).stdout.strip()
    quality["generated"] = {
        "commit": commit,
        "unix_time": int(_time.time()),
        "via": "python bench.py --quality",
    }
    quality_path.write_text(json.dumps(quality, indent=1) + "\n")
    print(json.dumps({"quality_regenerated": True, "commit": commit}))
    sys.exit(0)

import os

import numpy as np

from demuxalot_tpu.utils.platform import enable_persistent_compilation_cache

N_DONORS = int(os.environ.get("DEMUX_BENCH_DONORS", 32))
N_SNPS = int(os.environ.get("DEMUX_BENCH_SNPS", 65_536))
N_BARCODES = int(os.environ.get("DEMUX_BENCH_BARCODES", 65_536))
CALLS_PER_BARCODE = int(os.environ.get("DEMUX_BENCH_CALLS_PER_BARCODE", 64))  # ~4.2M calls
DOUBLET_PRIOR = 0.35

# Published peaks, dense, no sparsity (NVIDIA H100 SXM data sheet). A card
# missing from this table is an error: no roofline against a guessed peak.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}


def _numpy_reference_logits(genotype_prob, vid, cb, q, n_barcodes, n_donors, doublet_prior):
    """Per-pseudogenotype loop exactly in the reference's compute style."""
    n_pairs = n_donors * (n_donors - 1) // 2
    n_pg = n_donors + (n_pairs if doublet_prior else 0)
    logits = np.zeros([n_barcodes, n_pg], dtype="float32")
    cols = [genotype_prob[:, g] for g in range(n_donors)]
    if doublet_prior:
        for i in range(n_donors):
            for j in range(i + 1, n_donors):
                cols.append((genotype_prob[:, i] + genotype_prob[:, j]) * 0.5)
    for pg, variant2prob in enumerate(cols):
        p = variant2prob[vid]
        log_penalties = np.log(p * (1 - q) + q.clip(1e-4))
        logits[:, pg] += np.bincount(cb, weights=log_penalties, minlength=n_barcodes).astype("float32")
    return logits


def estep_hbm_bytes(n_calls, n_variants, n_donors, n_barcodes, n_pg) -> int:
    """Least device-memory traffic of one E-step: calls, table, logits."""
    return n_calls * 12 + n_variants * n_donors * 4 + n_barcodes * n_pg * 4


def main():
    import jax
    import jax.numpy as jnp

    from benchmarks._timing import warm_time
    from demuxalot_tpu.ops import estep_kernel as K
    from demuxalot_tpu.ops import likelihood as L
    from demuxalot_tpu.sim import synthesize_device_workload

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {jax.default_backend()!r}")
    enable_persistent_compilation_cache()
    device = jax.devices()[0]
    peaks = PEAKS[device.device_kind]

    betas, variant2snp, vid, cb, q, _truth = synthesize_device_workload(
        N_BARCODES, N_DONORS, N_SNPS, CALLS_PER_BARCODE, seed=0
    )
    n_variants = betas.shape[0]
    names = [f"D{i:02}" for i in range(N_DONORS)]
    mixing, _ = L.pseudogenotype_mixing(names, DOUBLET_PRIOR)
    penalties = L.doublet_penalties(N_DONORS, DOUBLET_PRIOR)
    n_pg = mixing.shape[1]
    n_calls = len(vid)
    evals = n_calls * n_pg

    betas_d, v2s_d = jnp.asarray(betas), jnp.asarray(variant2snp)
    mix_d, pen_d = jnp.asarray(mixing), jnp.asarray(penalties)
    vid_d, cb_d, q_d = jnp.asarray(vid), jnp.asarray(cb), jnp.asarray(q)
    vorder = np.argsort(vid, kind="stable")
    vid_v, cb_v, q_v = (jnp.asarray(x[vorder]) for x in (vid, cb, q))
    runs = K.CallRuns.build(cb, vid, q, N_BARCODES)
    runs_d = [jnp.asarray(x) for x in (runs.offsets, runs.vid, runs.q)]
    doublets = K.check_mixing(mixing)

    def genotype_prob(addition):
        # sim's variant2snp is SNP-sorted (2 variants per SNP): windowed path
        return L.probs_from_betas(betas_d + addition, v2s_d, N_SNPS, 0.01, max_per_snp=2)

    esteps = {
        "xla": lambda a: L.barcode_logits(
            genotype_prob(a), mix_d, pen_d, vid_d, cb_d, q_d, N_BARCODES),
        "kernel": lambda a: K.estep_logits(
            genotype_prob(a), pen_d, *runs_d, n_barcodes=N_BARCODES, doublets=doublets),
    }

    def mstep(probs):
        return L.genotype_addition_from_posteriors(
            probs, vid_v, cb_v, q_v, n_variants, N_DONORS, 2.0)

    zero = jnp.zeros_like(betas_d)
    timings = {}
    for name, estep in esteps.items():
        def em_iteration(a, estep=estep):
            return mstep(jax.nn.softmax(estep(a), axis=-1))

        timings[f"estep_{name}"] = warm_time(jax.jit(estep), zero)
        timings[f"em_iteration_{name}"] = warm_time(jax.jit(em_iteration), zero)
    probs = jax.nn.softmax(jax.jit(esteps["xla"])(zero), axis=-1)
    timings["mstep_xla"] = warm_time(jax.jit(mstep), probs)

    best = min(timings["estep_xla"]["min_s"], timings["estep_kernel"]["min_s"])
    device_rate = evals / best
    hbm_floor_s = estep_hbm_bytes(n_calls, n_variants, N_DONORS, N_BARCODES, n_pg) / peaks["hbm_bytes_per_s"]

    # --- numpy baseline (reference compute style), subsampled --------------
    sub = min(n_calls, 200_000)
    gp_np = np.asarray(genotype_prob(zero))
    t0 = time.perf_counter()
    _numpy_reference_logits(gp_np, vid[:sub], cb[:sub], q[:sub], N_BARCODES, N_DONORS, DOUBLET_PRIOR)
    baseline_rate = sub * n_pg / (time.perf_counter() - t0)

    result = {
        "metric": "likelihood_evals_per_s_per_chip",
        "value": round(device_rate, 1),
        "unit": "call*pseudogenotype evals/s",
        "vs_baseline": round(device_rate / baseline_rate, 2),
        "device": {
            "platform": device.platform,
            "kind": device.device_kind,
            "count": len(jax.devices()),
        },
        "config": {
            "n_donors": N_DONORS,
            "n_pseudogenotypes": n_pg,
            "n_barcodes": N_BARCODES,
            "n_calls": n_calls,
            "n_snps": N_SNPS,
            "baseline_numpy_evals_per_s": round(baseline_rate, 1),
            "estep_hbm_floor_s": hbm_floor_s,
            "em_barcodes_per_s": N_BARCODES / min(
                timings["em_iteration_xla"]["min_s"], timings["em_iteration_kernel"]["min_s"]),
        },
        "timings": timings,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
