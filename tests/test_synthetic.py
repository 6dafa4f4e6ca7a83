"""End-to-end tests on synthetic BAM + genotypes (all data generated here).

Mirrors the reference's test strategy (tests/test_synthetic.py): build a
real sorted+indexed BAM through the framework's own writer, run the full
pipeline, and check demultiplexing quality under degraded genotypes, the
semi-supervised path, and the parquet checkpoint round-trip.
"""
import tempfile

import numpy as np
import pandas as pd
import pytest

from demuxalot_tpu import BarcodeHandler, Demultiplexer, ProbabilisticGenotypes, count_snps
from demuxalot_tpu.sim import generate_bam_file


def compute_loss(barcode2donor_names, barcode2probs):
    """Mean -log P(true donors), clipped."""
    probs = barcode2probs * 0
    for barcode, correct_donors in barcode2donor_names.items():
        for donor in correct_donors:
            probs.loc[barcode, donor] = barcode2probs.loc[barcode, donor]
    p = probs.sum(axis=1)
    return -np.log(p.clip(1e-4)).mean()


@pytest.fixture(scope="module")
def synthetic_data(tmp_path_factory):
    np.random.seed(42)
    filename = str(tmp_path_factory.mktemp("bam") / "test.bam")
    filename, genotypes, barcode2donor_ids, barcode2donor_names = generate_bam_file(
        filename,
        n_genotypes=12,
        doublets_fraction=0.2,
        mutation_prob=0.01,
        n_barcodes=600,
        n_reads_per_barcode=80,
    )
    barcode_handler = BarcodeHandler(list(barcode2donor_names))
    calls = count_snps(
        filename,
        chromosome2positions=genotypes.get_chromosome2positions(),
        barcode_handler=barcode_handler,
        joblib_n_jobs=4,
        joblib_verbosity=0,
    )
    return filename, genotypes, barcode2donor_names, barcode_handler, calls


def test_demultiplex_start_from_genotypes(synthetic_data):
    """Quality across different amounts of prior genotype information."""
    _filename, genotypes, barcode2correct_donor, barcode_handler, calls = synthetic_data

    noise_percent2loss = {}
    for noise_percent in [0.0, 0.9, 1.0]:
        ng = genotypes.clone()
        # erase a fraction of SNPs from the genotype prior
        snp_ids = ng.get_snp_ids_for_variants()
        snp_mask = np.random.random(snp_ids.max() + 1) < noise_percent
        ng.variant_betas[snp_mask[snp_ids], :] = 0

        _logits, barcode2donor_probs = Demultiplexer.predict_posteriors(
            calls, ng, barcode_handler=barcode_handler, doublet_prior=0.0
        )
        loss_no_learning = compute_loss(barcode2correct_donor, barcode2donor_probs)

        _learnt, barcode2donor_probs = Demultiplexer.learn_genotypes(
            calls, ng, barcode_handler=barcode_handler, doublet_prior=0.0
        )
        loss_learning = compute_loss(barcode2correct_donor, barcode2donor_probs)
        noise_percent2loss[noise_percent] = {
            "no learning": loss_no_learning,
            "learning": loss_learning,
        }
    print(pd.DataFrame(noise_percent2loss))

    for label in noise_percent2loss[1.0]:
        assert noise_percent2loss[1.0][label] > noise_percent2loss[0.0][label]
    # with full genotypes, predictions should be confidently right
    assert noise_percent2loss[0.0]["no learning"] < 0.5
    # at 90% degradation, EM learning should substantially beat no-learning
    assert noise_percent2loss[0.9]["learning"] < noise_percent2loss[0.9]["no learning"]


def test_demultiplex_start_from_assignment(synthetic_data):
    """Label a fraction of barcodes; genotypes must be learnt from scratch."""
    _filename, genotypes, barcode2correct_donor, barcode_handler, calls = synthetic_data
    empty_genotypes = genotypes.clone()
    empty_genotypes.variant_betas[:] = 0

    # dry run provides a correctly-shaped dataframe for the prior logits
    _lg, barcode2donor_probs = Demultiplexer.learn_genotypes(
        calls, empty_genotypes, barcode_handler=barcode_handler
    )

    labelling_p = np.random.random(size=len(barcode2correct_donor))
    barcode2donor_logits: pd.DataFrame = barcode2donor_probs * 0

    labeled_fraction2loss = {}
    for labeled_fraction in (0.05, 0.2, 0.5):
        for (barcode, correct_donor_names), p_label in zip(
            barcode2correct_donor.items(), labelling_p
        ):
            if len(correct_donor_names) == 1 and p_label < labeled_fraction:
                [correct_donor] = correct_donor_names
                barcode2donor_logits.loc[barcode, str(correct_donor)] += 100.0

        _lg, barcode2donor_probs = Demultiplexer.learn_genotypes(
            calls,
            empty_genotypes,
            barcode_handler=barcode_handler,
            barcode_prior_logits=barcode2donor_logits.values,
        )
        loss = compute_loss(barcode2correct_donor, barcode2donor_probs)
        print(f"labeled fraction of barcodes: {labeled_fraction:<5}  loss={loss:8.4f}")
        labeled_fraction2loss[labeled_fraction] = loss

    for labeled_fraction, loss in labeled_fraction2loss.items():
        if labeled_fraction > 0.15 and loss > 0.1:
            raise RuntimeError(f"Error is too high {labeled_fraction} {loss}")


def test_anchored_damping(synthetic_data):
    """damping="anchor" freezes prior-less variants and never diverges.

    At heavy degradation the default EM (like the reference, measured
    identical in QUALITY.json) diverges through unanchored variants; the
    anchored M-step must (a) leave prior-less variants untouched, (b) not
    lose to prior-only inference, and (c) be a no-op when every variant has
    a prior.
    """
    _f, genotypes, barcode2correct_donor, barcode_handler, calls = synthetic_data

    ng = genotypes.clone()
    snp_ids = ng.get_snp_ids_for_variants()
    rng = np.random.RandomState(5)
    snp_mask = rng.random_sample(snp_ids.max() + 1) < 0.95
    erased_rows = np.nonzero(snp_mask[snp_ids])[0]
    ng.variant_betas[erased_rows, :] = 0

    _lg, prior_probs = Demultiplexer.predict_posteriors(
        calls, ng, barcode_handler=barcode_handler, doublet_prior=0.0
    )
    loss_prior = compute_loss(barcode2correct_donor, prior_probs)

    learnt, probs = Demultiplexer.learn_genotypes(
        calls, ng, barcode_handler=barcode_handler, doublet_prior=0.0,
        damping="anchor",
    )
    loss_anchored = compute_loss(barcode2correct_donor, probs)
    print(f"prior-only {loss_prior:.4f} vs anchored EM {loss_anchored:.4f}")
    # (a) erased variants received no addition
    addition = learnt.get_betas() - ng.get_betas()
    assert np.all(addition[erased_rows] == 0)
    assert np.any(addition[np.setdiff1d(np.arange(ng.n_variants), erased_rows)] > 0)
    # (b) anchored learning does not lose to no learning
    assert loss_anchored <= loss_prior + 1e-3

    # (c) full prior -> anchored EM == default EM exactly
    a, pa = Demultiplexer.learn_genotypes(
        calls, genotypes, barcode_handler=barcode_handler, n_iterations=2,
        damping="anchor",
    )
    b, pb = Demultiplexer.learn_genotypes(
        calls, genotypes, barcode_handler=barcode_handler, n_iterations=2,
    )
    np.testing.assert_allclose(pa.values, pb.values, atol=1e-6)
    np.testing.assert_allclose(a.get_betas(), b.get_betas(), rtol=1e-6)

    with pytest.raises(ValueError):
        Demultiplexer.learn_genotypes(
            calls, ng, barcode_handler=barcode_handler, damping="bogus"
        )


def test_auto_damping(synthetic_data):
    """damping="auto" matches the better of plain and anchored EM.

    The selector's contract (measured separation: converging runs disagree
    ≤ ~5% with the anchored witness, diverging ones ≥ 24%): never worse
    than both prior-only inference and plain EM, and exactly the plain
    result when every variant carries a prior (anchor == plain there).
    """
    _f, genotypes, barcode2correct_donor, barcode_handler, calls = synthetic_data

    ng = genotypes.clone()
    snp_ids = ng.get_snp_ids_for_variants()
    snp_mask = np.random.RandomState(5).random_sample(snp_ids.max() + 1) < 0.95
    ng.variant_betas[np.nonzero(snp_mask[snp_ids])[0], :] = 0

    _lg, prior_probs = Demultiplexer.predict_posteriors(
        calls, ng, barcode_handler=barcode_handler, doublet_prior=0.0
    )
    _l, plain_probs = Demultiplexer.learn_genotypes(
        calls, ng, barcode_handler=barcode_handler, doublet_prior=0.0
    )
    learnt, auto_probs = Demultiplexer.learn_genotypes(
        calls, ng, barcode_handler=barcode_handler, doublet_prior=0.0,
        damping="auto",
    )
    loss_auto = compute_loss(barcode2correct_donor, auto_probs)
    loss_bar = min(
        compute_loss(barcode2correct_donor, prior_probs),
        compute_loss(barcode2correct_donor, plain_probs),
    )
    assert auto_probs.attrs["damping_selected"] in (None, "anchor")
    assert 0.0 <= auto_probs.attrs["anchored_disagreement"] <= 1.0
    assert loss_auto <= loss_bar + 1e-3, (loss_auto, loss_bar)

    # full prior: anchor == plain, so auto must return the plain result
    a, pa = Demultiplexer.learn_genotypes(
        calls, genotypes, barcode_handler=barcode_handler, n_iterations=2,
        damping="auto",
    )
    b, pb = Demultiplexer.learn_genotypes(
        calls, genotypes, barcode_handler=barcode_handler, n_iterations=2,
    )
    assert pa.attrs["damping_selected"] is None
    np.testing.assert_allclose(pa.values, pb.values, atol=1e-6)
    np.testing.assert_allclose(a.get_betas(), b.get_betas(), rtol=1e-6)

    # the staged generator cannot decide mid-flight; the error says so
    with pytest.raises(ValueError, match="learn_genotypes"):
        next(Demultiplexer.staged_genotype_learning(
            calls, ng, barcode_handler=barcode_handler, damping="auto"
        ))


def test_genotypes_export_and_loading(synthetic_data):
    _f, genotypes, *_ = synthetic_data
    with tempfile.TemporaryDirectory() as dir:
        filename = f"{dir}/genotypes.parquet"
        genotypes.save_betas(filename)
        genotypes2 = ProbabilisticGenotypes(
            genotype_names=genotypes.genotype_names,
            default_prior=genotypes.default_prior,
        )
        genotypes2.add_prior_betas(filename)

        assert genotypes.genotype_names == genotypes2.genotype_names
        assert genotypes.default_prior == genotypes2.default_prior
        assert set(genotypes.var2varid) == set(genotypes2.var2varid)
        # betas must match variant-for-variant regardless of insertion order
        for variant in genotypes.var2varid:
            assert np.allclose(
                genotypes.variant_betas[genotypes.var2varid[variant]],
                genotypes2.variant_betas[genotypes2.var2varid[variant]],
            )


def test_aggregate_on_snps_path(synthetic_data):
    """The alternative per-SNP aggregation path should also demultiplex well."""
    _f, genotypes, barcode2correct_donor, barcode_handler, calls = synthetic_data
    try:
        Demultiplexer.aggregate_on_snps = True
        _logits, probs = Demultiplexer.predict_posteriors(
            calls, genotypes, barcode_handler=barcode_handler, doublet_prior=0.0
        )
    finally:
        Demultiplexer.aggregate_on_snps = False
    loss = compute_loss(barcode2correct_donor, probs)
    print("aggregate_on_snps loss:", loss)
    assert loss < 1.0
    assert np.allclose(probs.sum(axis=1), 1, atol=1e-3)


def test_aggregate_on_snps_em_loop(synthetic_data):
    """EM learning also runs through the per-SNP aggregation branch."""
    _f, genotypes, barcode2correct_donor, barcode_handler, calls = synthetic_data
    try:
        Demultiplexer.aggregate_on_snps = True
        learnt, probs = Demultiplexer.learn_genotypes(
            calls, genotypes, barcode_handler=barcode_handler, n_iterations=2
        )
    finally:
        Demultiplexer.aggregate_on_snps = False
    assert np.allclose(probs.sum(axis=1).values, 1, atol=1e-3)
    loss = compute_loss(barcode2correct_donor, probs)
    print("aggregate_on_snps EM loss:", loss)
    assert loss < 1.0
    # learning only ever adds information on top of the frozen prior
    assert np.all(learnt.get_betas() >= genotypes.get_betas() - 1e-6)


def test_learn_genotypes_equals_staged_last_yield(synthetic_data):
    """The device-resident fast path must equal consuming the generator."""
    _f, genotypes, _truth, barcode_handler, calls = synthetic_data
    learnt_fast, probs_fast = Demultiplexer.learn_genotypes(
        calls, genotypes, barcode_handler=barcode_handler, n_iterations=3
    )
    *_, (probs_gen, debug) = Demultiplexer.staged_genotype_learning(
        calls, genotypes, barcode_handler=barcode_handler, n_iterations=3
    )
    learnt_gen = genotypes._with_betas(genotypes.get_betas() + debug["genotype_addition"])
    np.testing.assert_array_equal(probs_fast.values, probs_gen.values)
    assert list(probs_fast.index) == list(probs_gen.index)
    np.testing.assert_array_equal(learnt_fast.get_betas(), learnt_gen.get_betas())


def test_stage_timings_hook(synthetic_data):
    """The benchmark stage-timing hook records phases without changing results.

    benchmarks/end_to_end.py relies on these keys for the artifact's
    link_accounting section; the hook must be a pure observer (identical
    posteriors) and default-off (no keys recorded when unset).
    """
    from demuxalot_tpu.models import demux as demux_mod

    _f, genotypes, _truth, barcode_handler, calls = synthetic_data
    try:
        _lg, probs_plain = Demultiplexer.predict_posteriors(
            calls, genotypes, barcode_handler=barcode_handler, doublet_prior=0.35
        )
        assert demux_mod.STAGE_TIMINGS is None
        demux_mod.STAGE_TIMINGS = {}
        _lg, probs_timed = Demultiplexer.predict_posteriors(
            calls, genotypes, barcode_handler=barcode_handler, doublet_prior=0.35
        )
        predict_detail = demux_mod.STAGE_TIMINGS
        demux_mod.STAGE_TIMINGS = {}
        _learnt, probs_em = Demultiplexer.learn_genotypes(
            calls, genotypes, barcode_handler=barcode_handler, n_iterations=2
        )
        learn_detail = demux_mod.STAGE_TIMINGS
    finally:
        demux_mod.STAGE_TIMINGS = None

    np.testing.assert_array_equal(probs_plain.values, probs_timed.values)
    for key in ("pack_s", "forward_s", "materialize_s", "d2h_logits_s",
                "d2h_logits_bytes"):
        assert key in predict_detail, (key, predict_detail)
    for key in ("pack_s", "layout_s", "upload_flush_s", "h2d_bytes",
                "device_loop_s", "materialize_s", "d2h_addition_bytes"):
        assert key in learn_detail, (key, learn_detail)
    for detail in (predict_detail, learn_detail):
        for key, value in detail.items():
            if key.endswith("_s"):
                assert 0 <= value < 600, (key, value)
    assert predict_detail["d2h_logits_bytes"] == probs_timed.values.nbytes
    assert np.allclose(probs_em.sum(axis=1).values, 1, atol=1e-3)


def test_packed_calls_reuse(synthetic_data, tmp_path):
    """One PackedCalls drives every entry point bit-identically to re-packing.

    The pack-once engine must be a pure cache: identical logits/betas vs the
    per-call packing path, reuse across the learn -> predict-on-learnt flow,
    and a hard error when the variant registry changes.
    """
    from demuxalot_tpu import PackedCalls

    _f, genotypes, _truth, handler, calls = synthetic_data
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    assert isinstance(packed, PackedCalls)

    learnt_ref, probs_ref = Demultiplexer.learn_genotypes(
        calls, genotypes, barcode_handler=handler, n_iterations=3
    )
    learnt_p, probs_p = Demultiplexer.learn_genotypes(
        packed, genotypes, barcode_handler=handler, n_iterations=3
    )
    np.testing.assert_array_equal(probs_ref.values, probs_p.values)
    np.testing.assert_array_equal(learnt_ref.get_betas(), learnt_p.get_betas())

    # the learnt clone differs only in beta values: the SAME packed
    # dataset serves predict (the standard product flow)
    lg_ref, pr_ref = Demultiplexer.predict_posteriors(
        calls, learnt_ref, barcode_handler=handler, doublet_prior=0.35
    )
    lg_p, pr_p = Demultiplexer.predict_posteriors(
        packed, learnt_p, barcode_handler=handler, doublet_prior=0.35
    )
    np.testing.assert_array_equal(lg_ref.values, lg_p.values)
    np.testing.assert_array_equal(pr_ref.values, pr_p.values)

    # the flat device layout was built once and shared
    assert len(packed._device_flat) == 1

    # the staged generator accepts it too
    *_, (probs_gen, _dbg) = Demultiplexer.staged_genotype_learning(
        packed, genotypes, barcode_handler=handler, n_iterations=3
    )
    np.testing.assert_array_equal(probs_gen.values, probs_p.values)

    # damping="auto" shares the packed dataset between its two runs
    _la, probs_auto = Demultiplexer.learn_genotypes(
        packed, genotypes, barcode_handler=handler, n_iterations=2,
        damping="auto",
    )
    assert np.allclose(probs_auto.sum(axis=1).values, 1, atol=1e-3)

    # a genotypes object with a DIFFERENT registry must be rejected
    changed = genotypes.clone()
    extra = pd.DataFrame(
        {d: [1.0] for d in genotypes.genotype_names},
        index=pd.MultiIndex.from_tuples(
            [("chr1", 10**7, "A")], names=["CHROM", "POS", "BASE"]
        ),
    )
    extra_path = str(tmp_path / "extra_betas.parquet")
    extra.to_parquet(extra_path)
    changed.add_prior_betas(extra_path, prior_strength=1.0)
    with pytest.raises(ValueError, match="different variant registry"):
        Demultiplexer.predict_posteriors(
            packed, changed, barcode_handler=handler
        )


def test_predict_posteriors_compact(synthetic_data):
    """Compact top-k output matches the full-frame contract exactly.

    The compact path must move <= 1/4 the bytes while
    keeping assignments bit-identical to argmax over the full f32 frame,
    top-k logits as exact frame entries, and optional bf16 logits within
    1 bf16 ulp.
    """
    _filename, genotypes, _truth, handler, calls = synthetic_data

    packed = Demultiplexer.pack_dataset(calls, genotypes)
    logits_df, probs_df = Demultiplexer.predict_posteriors(
        packed, genotypes, barcode_handler=handler, doublet_prior=0.35
    )
    compact = Demultiplexer.predict_posteriors_compact(
        packed, genotypes, barcode_handler=handler, doublet_prior=0.35,
        k=4, include_logits=True,
    )

    full = logits_df.values
    # assignments bit-identical to the full-frame argmax (same tie rule)
    np.testing.assert_array_equal(compact.assignment, full.argmax(axis=1))
    assert list(compact.barcodes) == list(logits_df.index)
    assert compact.column_names == list(logits_df.columns)

    # top-k logits are the exact f32 frame entries at the top-k indices
    rows = np.arange(full.shape[0])[:, None]
    np.testing.assert_array_equal(
        compact.top_logits, full[rows, compact.top_index]
    )
    # top-k is genuinely descending and covers the true top of each row
    assert (np.diff(compact.top_logits, axis=1) <= 0).all()
    np.testing.assert_array_equal(
        compact.top_logits[:, 0], full.max(axis=1)
    )

    # reconstructed top-1 probability matches the full softmax frame
    top1_full = probs_df.values[rows[:, 0], compact.assignment]
    np.testing.assert_allclose(compact.top_probs[:, 0], top1_full, atol=1e-5)

    # bf16 logits within 1 bf16 ulp of the f32 frame (round-to-nearest)
    bf = compact.logits_bf16.astype(np.float32)
    ulp = np.maximum(np.abs(full) * 2.0**-7, np.finfo(np.float32).tiny)
    assert (np.abs(bf - full) <= ulp).all()

    # default compact output (no bf16 frame) moves <= 1/4 of the full bytes
    compact_small = Demultiplexer.predict_posteriors_compact(
        packed, genotypes, barcode_handler=handler, doublet_prior=0.35, k=4
    )
    assert compact_small.logits_bf16 is None
    assert compact_small.bytes_moved <= full.nbytes // 4
    np.testing.assert_array_equal(compact_small.assignment, compact.assignment)

    # summary dataframe carries names + exact margin
    df = compact.to_dataframe()
    assert list(df.index) == list(logits_df.index)
    assert (df["logit_margin"].values >= 0).all()
    assert df.loc[df.index[0], "assignment"] == compact.assignment_names[0]
    # full-frame reconstruction only exists when requested
    assert compact.logits_dataframe().shape == logits_df.shape
    with pytest.raises(ValueError, match="include_logits"):
        compact_small.logits_dataframe()


def test_predict_posteriors_compact_k1(synthetic_data):
    """k=1 results have no runner-up: clean errors, trimmed dataframe."""
    _filename, genotypes, _truth, handler, calls = synthetic_data
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    compact = Demultiplexer.predict_posteriors_compact(
        packed, genotypes, barcode_handler=handler, doublet_prior=0.0, k=1
    )
    logits_df, _ = Demultiplexer.predict_posteriors(
        packed, genotypes, barcode_handler=handler, doublet_prior=0.0
    )
    np.testing.assert_array_equal(
        compact.assignment, logits_df.values.argmax(axis=1)
    )
    df = compact.to_dataframe()
    assert list(df.columns) == ["assignment", "posterior"]
    with pytest.raises(ValueError, match="runner-up"):
        compact.runner_up
    with pytest.raises(ValueError, match="margin"):
        compact.margin


def test_predict_posteriors_compact_rejects_bad_k(synthetic_data):
    """Non-positive k fails fast with a clear error, before any forward."""
    _filename, genotypes, _truth, handler, calls = synthetic_data
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="k must be >= 1"):
            Demultiplexer.predict_posteriors_compact(
                packed, genotypes, barcode_handler=handler, k=bad
            )
