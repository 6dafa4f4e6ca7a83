"""Reference-scale synthetic quality run (perf-marked).

The reference's synthetic harness runs 20 donors x 1000 barcodes x 100
reads at seed 42 (/root/reference/tests/test_synthetic.py:106-198); this
test reproduces that configuration end-to-end through this framework and
writes the measured losses to ``QUALITY.json`` at the repo root so every
round's numbers are a recorded artifact rather than prose.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from demuxalot_tpu import BarcodeHandler, Demultiplexer, count_snps
from demuxalot_tpu.sim import generate_bam_file

ARTIFACT = Path(__file__).resolve().parent.parent / "QUALITY.json"


def compute_loss(barcode2donor_names, barcode2probs):
    """Mean -log P(true donors), clipped (same metric as test_synthetic)."""
    probs = barcode2probs * 0
    for barcode, correct_donors in barcode2donor_names.items():
        for donor in correct_donors:
            probs.loc[barcode, donor] = barcode2probs.loc[barcode, donor]
    return -np.log(probs.sum(axis=1).clip(1e-4)).mean()


@pytest.mark.perf
def test_reference_scale_quality(tmp_path_factory):
    np.random.seed(42)
    tmp = tmp_path_factory.mktemp("bam")
    filename = str(tmp / "ref_scale.bam")
    filename, genotypes, _ids, barcode2donor_names = generate_bam_file(
        filename,
        n_genotypes=20,
        doublets_fraction=0.2,
        mutation_prob=0.01,
        n_barcodes=1000,
        n_reads_per_barcode=100,
    )
    barcode_handler = BarcodeHandler(list(barcode2donor_names))
    calls = count_snps(
        filename,
        chromosome2positions=genotypes.get_chromosome2positions(),
        barcode_handler=barcode_handler,
        joblib_n_jobs=4,
        joblib_verbosity=0,
    )

    results = {}
    degraded_by_noise = {}

    def eval_noise(noise_fraction, erase_rng):
        degraded = genotypes.clone()
        snp_ids = degraded.get_snp_ids_for_variants()
        erased = erase_rng.random(snp_ids.max() + 1) < noise_fraction
        degraded.variant_betas[erased[snp_ids], :] = 0
        degraded_by_noise[noise_fraction] = degraded

        _lg, probs = Demultiplexer.predict_posteriors(
            calls, degraded, barcode_handler=barcode_handler, doublet_prior=0.0
        )
        loss_prior_only = compute_loss(barcode2donor_names, probs)
        _learnt, probs = Demultiplexer.learn_genotypes(
            calls, degraded, barcode_handler=barcode_handler, doublet_prior=0.0
        )
        loss_after_em = compute_loss(barcode2donor_names, probs)
        _learnt, probs = Demultiplexer.learn_genotypes(
            calls, degraded, barcode_handler=barcode_handler, doublet_prior=0.0,
            damping="anchor",
        )
        loss_damped = compute_loss(barcode2donor_names, probs)
        _learnt, probs = Demultiplexer.learn_genotypes(
            calls, degraded, barcode_handler=barcode_handler, doublet_prior=0.0,
            damping="auto",
        )
        loss_auto = compute_loss(barcode2donor_names, probs)
        results[str(noise_fraction)] = {
            "loss_prior_only": round(float(loss_prior_only), 4),
            "loss_after_em": round(float(loss_after_em), 4),
            "loss_after_damped_em": round(float(loss_damped), 4),
            "loss_after_auto_em": round(float(loss_auto), 4),
            "auto_selected": probs.attrs["damping_selected"] or "plain",
            "auto_disagreement": round(float(probs.attrs["anchored_disagreement"]), 4),
        }
        print(f"noise={noise_fraction}: prior-only {loss_prior_only:.4f}, "
              f"after EM {loss_after_em:.4f}, damped {loss_damped:.4f}, "
              f"auto {loss_auto:.4f} ({results[str(noise_fraction)]['auto_selected']})")

    # the original three points consume the module-seeded global stream in
    # this exact order — keeping their masks (and the 0.95 parity trajectory
    # below) byte-stable across rounds
    for noise_fraction in (0.0, 0.95, 1.0):
        eval_noise(noise_fraction, np.random)

    # --- semi-supervised: empty genotypes + a fraction of labeled barcodes
    # (reference analogue: tests/test_synthetic.py:163-239 start-from-
    # assignment path) ------------------------------------------------------
    empty = genotypes.clone()
    empty.variant_betas[: empty.n_variants] = 0
    _lg, template_probs = Demultiplexer.learn_genotypes(
        calls, empty, barcode_handler=barcode_handler
    )
    labelling_p = np.random.random(size=len(barcode2donor_names))
    semi_supervised = {}
    # the reference's own sweep spans 1-50% labeled
    # (/root/reference/tests/test_synthetic.py:200-239); its acceptance bar
    # is loss < 0.1 once >= 20% of barcodes carry labels
    for labeled_fraction in (0.01, 0.05, 0.1, 0.2, 0.3, 0.5):
        prior_logits = template_probs * 0  # fresh per fraction: no label carry-over
        for (barcode, correct), p_label in zip(barcode2donor_names.items(), labelling_p):
            if len(correct) == 1 and p_label < labeled_fraction:
                prior_logits.loc[barcode, str(correct[0])] += 100.0
        _lg, probs = Demultiplexer.learn_genotypes(
            calls, empty, barcode_handler=barcode_handler,
            barcode_prior_logits=prior_logits.values,
        )
        loss = compute_loss(barcode2donor_names, probs)
        semi_supervised[str(labeled_fraction)] = round(float(loss), 4)
        print(f"semi-supervised labeled={labeled_fraction}: loss {loss:.4f}")

    # --- head-to-head parity vs the reference EM on identical inputs -------
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from reference_adapter import load_reference, reference_staged_losses

    parity = None
    reference = load_reference()
    if reference is not None:
        degraded = degraded_by_noise[0.95]
        n_iterations = 6

        def loss_fn(probs_df):
            return compute_loss(barcode2donor_names, probs_df)

        ours = []
        for probs_df, _debug in Demultiplexer.staged_genotype_learning(
            calls, degraded, barcode_handler=barcode_handler,
            n_iterations=n_iterations, doublet_prior=0.0,
        ):
            ours.append(round(float(loss_fn(probs_df)), 4))
        theirs = reference_staged_losses(
            reference, calls, degraded, list(barcode2donor_names),
            n_iterations, loss_fn, tmp,
        )
        parity = {
            "noise_fraction": 0.95,
            "n_iterations": n_iterations,
            "loss_per_iteration_ours": ours,
            "loss_per_iteration_reference": theirs,
            "max_abs_diff": round(float(np.max(np.abs(np.array(ours) - np.array(theirs)))), 4),
        }
        print("parity ours:     ", ours)
        print("parity reference:", theirs)

    # densify the sweep between the clean and divergent regimes; independent
    # per-point generators so adding/removing points never perturbs the
    # byte-stable masks of the original three
    for noise_fraction in (0.5, 0.8, 0.9):
        eval_noise(noise_fraction, np.random.RandomState(1000 + int(noise_fraction * 100)))

    # --- second calibration family for the auto-damping selector -----------
    # (the disagreement threshold was first calibrated on one
    # synthetic family). Different regime on purpose — fewer donors, denser
    # SNPs, fewer reads — and fully independent RNG: the global stream
    # feeding the sections above is already consumed, so reseeding here
    # leaves every earlier mask byte-stable.
    np.random.seed(777)
    fam2_config = {"n_genotypes": 8, "n_barcodes": 600, "n_reads_per_barcode": 60,
                   "doublets_fraction": 0.1, "mutation_prob": 0.03, "seed": 777}
    fam2_file = str(tmp / "family2.bam")
    fam2_file, fam2_gt, _f2ids, fam2_truth = generate_bam_file(
        fam2_file,
        n_genotypes=fam2_config["n_genotypes"],
        doublets_fraction=fam2_config["doublets_fraction"],
        mutation_prob=fam2_config["mutation_prob"],
        n_barcodes=fam2_config["n_barcodes"],
        n_reads_per_barcode=fam2_config["n_reads_per_barcode"],
    )
    fam2_handler = BarcodeHandler(list(fam2_truth))
    fam2_calls = count_snps(
        fam2_file,
        chromosome2positions=fam2_gt.get_chromosome2positions(),
        barcode_handler=fam2_handler,
        joblib_n_jobs=4,
        joblib_verbosity=0,
    )
    fam2 = {}
    for noise_fraction in (0.5, 0.9, 0.95):
        degraded = fam2_gt.clone()
        snp_ids = degraded.get_snp_ids_for_variants()
        erased = (
            np.random.RandomState(2000 + int(noise_fraction * 100)).random(snp_ids.max() + 1)
            < noise_fraction
        )
        degraded.variant_betas[erased[snp_ids], :] = 0
        row = {}
        _lg, probs = Demultiplexer.predict_posteriors(
            fam2_calls, degraded, barcode_handler=fam2_handler, doublet_prior=0.0
        )
        row["loss_prior_only"] = round(float(compute_loss(fam2_truth, probs)), 4)
        for damping, key in (
            (None, "loss_after_em"),
            ("anchor", "loss_after_damped_em"),
            ("auto", "loss_after_auto_em"),
        ):
            _l, probs = Demultiplexer.learn_genotypes(
                fam2_calls, degraded, barcode_handler=fam2_handler,
                doublet_prior=0.0, damping=damping,
            )
            row[key] = round(float(compute_loss(fam2_truth, probs)), 4)
            if damping == "auto":
                row["auto_selected"] = probs.attrs["damping_selected"] or "plain"
                row["auto_disagreement"] = round(
                    float(probs.attrs["anchored_disagreement"]), 4
                )
        fam2[str(noise_fraction)] = row
        print(f"family2 noise={noise_fraction}: {row}")

    # keep sections other harnesses own (at_scale: benchmarks/at_scale_quality.py)
    existing = json.loads(ARTIFACT.read_text()) if ARTIFACT.exists() else {}
    preserved = {k: v for k, v in existing.items() if k in ("at_scale",)}
    content = {
        "config": {"n_genotypes": 20, "n_barcodes": 1000, "n_reads_per_barcode": 100,
                   "doublets_fraction": 0.2, "mutation_prob": 0.01, "seed": 42},
        "losses_by_noise_fraction": {
            k: results[k] for k in sorted(results, key=float)
        },
        "semi_supervised_loss_by_labeled_fraction": semi_supervised,
        "semi_supervised_reference_bar": "loss < 0.1 required at labeled_fraction >= 0.2",
        "reference_em_parity": parity,
        "auto_damping_second_family": {
            "config": fam2_config,
            "losses_by_noise_fraction": {
                k: fam2[k] for k in sorted(fam2, key=float)
            },
            "note": "independent synthetic regime validating the auto "
                    "selector's threshold beyond its original calibration "
                    "family; the contract below is asserted on both",
        },
        **preserved,
    }
    # the commit stamp (bench.py --quality) survives byte-stable reruns —
    # the provenance claim only drops when the recorded numbers CHANGED
    if "generated" in existing and {
        k: v for k, v in existing.items() if k != "generated"
    } == content:
        content["generated"] = existing["generated"]
    ARTIFACT.write_text(json.dumps(content, indent=1) + "\n")

    # in the mid-noise regime EM must actually help, and anchoring must not
    # hurt where the stock update already converges
    for mid in ("0.5", "0.8"):
        assert results[mid]["loss_after_em"] <= results[mid]["loss_prior_only"] + 1e-6
        assert results[mid]["loss_after_damped_em"] <= results[mid]["loss_prior_only"] + 1e-6

    # reference's acceptance bar (test_synthetic.py:196-198) + stronger checks
    assert results["1.0"]["loss_prior_only"] > results["0.0"]["loss_prior_only"]
    assert results["0.0"]["loss_prior_only"] < 0.5, "full genotypes must demultiplex confidently"
    # 5% surviving SNPs still demultiplex most barcodes correctly
    assert results["0.95"]["loss_prior_only"] < 2.0
    # the anchored M-step tames the divergent regime (the stock EM — and the
    # reference's, identically — ends far above prior-only here)
    assert (results["0.95"]["loss_after_damped_em"]
            < results["0.95"]["loss_prior_only"])
    # damping="auto" must match the better of plain EM and prior-only at
    # every point — the selector's whole contract
    for point, row in results.items():
        bar = min(row["loss_prior_only"], row["loss_after_em"]) + 1e-6
        assert row["loss_after_auto_em"] <= bar, (point, row)
    # ...and identically on the independent second family
    for point, row in fam2.items():
        bar = min(row["loss_prior_only"], row["loss_after_em"]) + 1e-6
        assert row["loss_after_auto_em"] <= bar, ("family2", point, row)
    # labels recover genotypes from nothing (reference bar: loss < 0.1 at
    # every >= 20% point; the low-label 1-10% cliff is recorded, not gated)
    for fraction, loss in semi_supervised.items():
        if float(fraction) >= 0.2:
            assert loss < 0.1, (fraction, loss)
    if parity is not None:
        # the EM trajectory — including the divergence both implementations
        # exhibit at 95% unsupervised degradation — must match the reference
        # iteration-for-iteration. We record, not hide, the regime where
        # unsupervised refinement fails; with supervision the same EM
        # converges (semi_supervised above), and at 90% degradation with
        # fewer donors it improves (test_synthetic.py).
        assert parity["max_abs_diff"] <= 2e-3, parity


@pytest.mark.perf
def test_end_to_end_harness_smoke(monkeypatch):
    """The E2E artifact harness stays runnable (quick shape, no baseline).

    Guards the reproducibility of E2E.json / E2E_PMBC.json: the harness
    is the artifact generator, so its breakage should show up in a perf
    run, not when regenerating the artifact.
    """
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmarks.end_to_end import main as e2e_main

    result = e2e_main(["--quick", "--skip-baseline"])
    assert result["config"]["n_barcodes"] == 4000
    assert result["total_pipeline_warm_s"] > 0
    assert result["quality"]["singlet_accuracy"] > 0.95
    assert not (Path(__file__).resolve().parent.parent / "E2E_quick.json").exists()
