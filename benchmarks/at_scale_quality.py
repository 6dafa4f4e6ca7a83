"""Truth-accuracy of the production device path at the bench shape.

The device path is tuned at 32 donors x 65,536 barcodes x ~4.2M calls,
while the reference-parity quality sweep runs at the reference's 20 x 1000
toy scale. This harness runs one truth-accuracy experiment at the bench
shape through the PUBLIC API (CompressedSNPCalls -> pack -> EM/posteriors)
and records it as the ``at_scale`` section of QUALITY.json:

* doublet-aware posterior accuracy (prior genotypes, doublet_prior=0.35);
* EM recovery from 90%-degraded genotypes (the regime where plain EM wins
  at toy scale), default path (the fused E-step kernel on a GPU) vs the
  XLA path on identical inputs — the loss agreement is the "production
  path computes the same statistics" proof at scale.

Methodology anchor: the reference's tests/test_synthetic.py:106-198 at 65x
the barcode count (synthetic truth, mean -log P(true donors) loss).

    python benchmarks/at_scale_quality.py          # bench shape (on a GPU)
    python benchmarks/at_scale_quality.py --quick  # small smoke shape
"""
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

from demuxalot_tpu.utils.platform import enable_persistent_compilation_cache

enable_persistent_compilation_cache()

QUALITY = REPO / "QUALITY.json"

from _metrics import doublet_metrics, joint_loss, singlet_loss  # noqa: E402
from synth_calls import synthesize_compressed_calls  # noqa: E402


def _stage(msg):
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main(argv=None):
    import jax

    from demuxalot_tpu import BarcodeHandler, Demultiplexer
    from demuxalot_tpu.ops.estep_kernel import resolve_use_pallas

    argv = list(sys.argv[1:] if argv is None else argv)
    quick = "--quick" in argv
    if quick:
        n_donors, n_barcodes, n_snps, cpb = 8, 2048, 4096, 32
    else:
        n_donors, n_barcodes, n_snps, cpb = 32, 65_536, 65_536, 64

    device = jax.devices()[0]
    card = None
    if device.platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    _stage(f"synthesizing: {n_donors} donors x {n_barcodes} barcodes x "
           f"{n_snps} snps x {cpb} calls/barcode")
    genotypes, calls, truth, donor_names = synthesize_compressed_calls(
        n_barcodes, n_donors, n_snps, cpb
    )
    handler = BarcodeHandler([f"BC{b:06}" for b in range(n_barcodes)])

    # --- doublet-aware posterior quality with the full prior ---------------
    _stage("predict_posteriors (doublet_prior=0.35, production path)")
    t0 = time.perf_counter()
    _lg, probs = Demultiplexer.predict_posteriors(
        calls, genotypes, barcode_handler=handler, doublet_prior=0.35
    )
    t_predict = round(time.perf_counter() - t0, 2)
    predict_quality = {
        "loss_exact_truth_column": round(joint_loss(probs, truth), 4),
        "loss_singlet_columns": round(singlet_loss(probs, truth), 4),
        **doublet_metrics(probs, truth),
        "wall_s": t_predict,
    }
    _stage(f"predict quality: {predict_quality}")

    # --- EM recovery from 90%-degraded genotypes ---------------------------
    noise = 0.9
    degraded = genotypes.clone()
    erase_rng = np.random.RandomState(1234)
    snp_ids = degraded.get_snp_ids_for_variants()
    erased = erase_rng.random(snp_ids.max() + 1) < noise
    degraded.variant_betas[erased[snp_ids], :] = 0

    _lg, probs0 = Demultiplexer.predict_posteriors(
        calls, degraded, barcode_handler=handler, doublet_prior=0.0
    )
    loss_prior_only = round(singlet_loss(probs0, truth), 4)

    results_by_path = {}
    for path_name, use_pallas in (("default_path", None), ("xla", False)):
        prev = Demultiplexer.use_pallas
        Demultiplexer.use_pallas = use_pallas
        try:
            _stage(f"learn_genotypes at noise={noise} [{path_name}]")
            t0 = time.perf_counter()
            _learnt, probs_em = Demultiplexer.learn_genotypes(
                calls, degraded, barcode_handler=handler, n_iterations=5
            )
            wall = round(time.perf_counter() - t0, 2)
        finally:
            Demultiplexer.use_pallas = prev
        # doublet_prior=0 here (learn_genotypes default): only singlet
        # metrics are meaningful
        metrics = doublet_metrics(probs_em, truth)
        results_by_path[path_name] = {
            "loss_after_em": round(singlet_loss(probs_em, truth), 4),
            "singlet_accuracy": metrics["singlet_accuracy"],
            "wall_s": wall,
        }
        _stage(f"{path_name}: {results_by_path[path_name]}")

    section = {
        "config": {
            "n_donors": n_donors,
            "n_barcodes": n_barcodes,
            "n_snps": n_snps,
            "calls_per_barcode": cpb,
            "doublets_fraction": 0.2,
            "flip_prob": 0.02,
            "noise_fraction_for_em": noise,
            "seed": 0,
            "backend": device.platform,
            "device_kind": device.device_kind,
            # wall_s below are first-call seconds on this card, compiles included
            "card_name_power_limit": card,
            "default_path_estep": (
                "fused E-step kernel" if resolve_use_pallas(None)[0] else "XLA"
            ),
        },
        "reproduce": "python benchmarks/at_scale_quality.py",
        "predict_posteriors_full_prior": predict_quality,
        "em_from_90pct_degraded": {
            "loss_prior_only": loss_prior_only,
            **results_by_path,
            "default_vs_xla_loss_diff": round(
                abs(results_by_path["default_path"]["loss_after_em"]
                    - results_by_path["xla"]["loss_after_em"]), 5,
            ),
        },
    }

    if not quick:
        quality = json.loads(QUALITY.read_text()) if QUALITY.exists() else {}
        # the commit stamp belongs to `bench.py --quality` (which re-stamps
        # after running every section); it survives only if this rerun left
        # the recorded at_scale numbers unchanged — a stale provenance
        # claim must not outlive changed results
        if quality.get("at_scale") != section:
            quality.pop("generated", None)
        quality["at_scale"] = section
        QUALITY.write_text(json.dumps(quality, indent=1) + "\n")
    print(json.dumps(section))
    return section


if __name__ == "__main__":
    main()
