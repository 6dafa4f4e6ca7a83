"""Device-op correctness vs the numpy oracle (reference math)."""
import jax.numpy as jnp
import numpy as np
import pytest

from demuxalot_tpu.ops import likelihood as L
from demuxalot_tpu.ops import packing as P
from oracle import (
    oracle_barcode_calls,
    oracle_barcode_logits,
    oracle_doublet_penalties,
    oracle_mstep,
    oracle_probs_from_betas,
)


def _random_problem(seed=0, n_snps=200, n_donors=6, n_barcodes=300, n_calls=20000):
    rng = np.random.RandomState(seed)
    n_variants = n_snps * 2
    variant2snp = np.repeat(np.arange(n_snps, dtype=np.int32), 2)
    betas = (rng.rand(n_variants, n_donors) * 50).astype(np.float32)
    vid = rng.randint(0, n_variants, n_calls).astype(np.int32)
    cb = np.sort(rng.randint(0, n_barcodes, n_calls)).astype(np.int32)
    q = (rng.rand(n_calls) * 0.5).astype(np.float32)
    names = [f"Donor{i:02}" for i in range(n_donors)]
    return names, variant2snp, betas, vid, cb, q, n_barcodes, n_snps


def test_doublet_penalties_match_and_prior_mass():
    from scipy.special import softmax

    for n_genotypes in [2, 3, 10, 32]:
        for doublet_prior in [0.0, 0.25, 0.5]:
            ours = L.doublet_penalties(n_genotypes, doublet_prior)
            ref = oracle_doublet_penalties(n_genotypes, doublet_prior)
            np.testing.assert_allclose(ours, ref, rtol=1e-6)
            prior_probs = softmax(ours)
            assert np.allclose(prior_probs[:n_genotypes].sum(), 1 - doublet_prior)


def test_pseudogenotype_mixing_matches_enumeration():
    names = ["A", "B", "C", "D"]
    gprob = np.random.RandomState(1).rand(50, 4).astype(np.float32)
    mixing, col_names = L.pseudogenotype_mixing(names, doublet_prior=0.3)
    assert col_names == ["A", "B", "C", "D", "A+B", "A+C", "A+D", "B+C", "B+D", "C+D"]
    expanded = gprob @ mixing
    from oracle import iterate_pseudogenotypes

    for pg, name, col in iterate_pseudogenotypes(names, gprob, 0.3):
        assert name == col_names[pg]
        np.testing.assert_allclose(expanded[:, pg], col, rtol=1e-6)

    mixing0, names0 = L.pseudogenotype_mixing(names, doublet_prior=0.0)
    assert names0 == names
    np.testing.assert_array_equal(mixing0, np.eye(4, dtype=np.float32))


def test_probs_from_betas_matches_oracle():
    _, variant2snp, betas, *_rest, n_snps = _random_problem()
    ours = np.asarray(L.probs_from_betas(jnp.asarray(betas), jnp.asarray(variant2snp), n_snps, 0.01))
    ref = oracle_probs_from_betas(variant2snp, betas, 0.01)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("run_lengths", [[1], [2], [1, 2, 3, 4], [4, 1, 1, 4, 2]])
def test_probs_from_betas_windowed_matches_segment_path(run_lengths):
    # irregular same-SNP run lengths, repeated to a few hundred variants
    rng = np.random.RandomState(7)
    reps = list(run_lengths) * 60
    variant2snp = np.repeat(np.arange(len(reps), dtype=np.int32), reps)
    n_variants, n_snps = len(variant2snp), len(reps)
    betas = (rng.rand(n_variants, 5) * 80).astype(np.float32)
    ref = np.asarray(
        L.probs_from_betas(jnp.asarray(betas), jnp.asarray(variant2snp), n_snps, 0.01)
    )
    windowed = np.asarray(
        L.probs_from_betas(
            jnp.asarray(betas), jnp.asarray(variant2snp), n_snps, 0.01,
            max_per_snp=max(run_lengths),
        )
    )
    np.testing.assert_allclose(windowed, ref, rtol=1e-5, atol=1e-7)


def test_variant_reindex_roundtrip():
    rng = np.random.RandomState(3)
    # insertion-order variant2snp: deliberately shuffled SNP assignment
    variant2snp = rng.randint(0, 40, size=97).astype(np.int32)
    reindex = P.VariantReindex.build(variant2snp)
    assert (np.diff(reindex.variant2snp) >= 0).all()
    assert reindex.max_per_snp == int(np.bincount(variant2snp).max())
    table = rng.rand(97, 6).astype(np.float32)
    np.testing.assert_array_equal(
        reindex.unpermute_rows(reindex.permute_rows(table)), table
    )
    # remapped ids point at the same rows of the permuted table
    vid = rng.randint(0, 97, size=500)
    np.testing.assert_array_equal(
        reindex.permute_rows(table)[reindex.remap_variant_ids(vid)], table[vid]
    )
    # the permuted space feeds the windowed denominator path exactly
    n_snps = int(variant2snp.max()) + 1
    ref = oracle_probs_from_betas(variant2snp, table, 0.01)
    windowed = np.asarray(
        L.probs_from_betas(
            jnp.asarray(reindex.permute_rows(table)),
            jnp.asarray(reindex.variant2snp),
            n_snps, 0.01, max_per_snp=reindex.max_per_snp,
        )
    )
    np.testing.assert_allclose(reindex.unpermute_rows(windowed), ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
@pytest.mark.parametrize("call_chunk", [4096, 100_000])
def test_barcode_logits_matches_oracle(doublet_prior, call_chunk):
    names, variant2snp, betas, vid, cb, q, n_barcodes, n_snps = _random_problem()
    gprob = oracle_probs_from_betas(variant2snp, betas, 0.01)
    ref_logits, _ = oracle_barcode_logits(names, gprob, vid, cb, q, n_barcodes, doublet_prior)

    mixing, _ = L.pseudogenotype_mixing(names, doublet_prior)
    penalties = L.doublet_penalties(len(names), doublet_prior)
    ours = np.asarray(
        L.barcode_logits(
            jnp.asarray(gprob), jnp.asarray(mixing), jnp.asarray(penalties),
            jnp.asarray(vid), jnp.asarray(cb), jnp.asarray(q),
            n_barcodes, call_chunk=call_chunk,
        )
    )
    np.testing.assert_allclose(ours, ref_logits, rtol=1e-4, atol=5e-3)


def test_padding_calls_are_exact_noops():
    names, variant2snp, betas, vid, cb, q, n_barcodes, n_snps = _random_problem(n_calls=5000)
    gprob = oracle_probs_from_betas(variant2snp, betas, 0.01)
    mixing, _ = L.pseudogenotype_mixing(names, 0.35)
    penalties = L.doublet_penalties(len(names), 0.35)

    def run(v, c, qq):
        return np.asarray(
            L.barcode_logits(
                jnp.asarray(gprob), jnp.asarray(mixing), jnp.asarray(penalties),
                jnp.asarray(v), jnp.asarray(c), jnp.asarray(qq), n_barcodes,
            )
        )

    base = run(vid, cb, q)
    pad = 1234
    padded = run(
        np.concatenate([vid, np.zeros(pad, np.int32)]),
        np.concatenate([cb, np.full(pad, n_barcodes - 1, np.int32)]),
        np.concatenate([q, np.ones(pad, np.float32)]),
    )
    np.testing.assert_array_equal(base, padded)

    # M-step padding is also an exact no-op
    post = np.random.RandomState(3).rand(n_barcodes, len(names)).astype(np.float32)
    a = np.asarray(
        L.genotype_addition_from_posteriors(
            jnp.asarray(post), jnp.asarray(np.sort(vid)), jnp.asarray(cb), jnp.asarray(q),
            len(variant2snp), len(names), 2.0,
        )
    )
    b = np.asarray(
        L.genotype_addition_from_posteriors(
            jnp.asarray(post),
            jnp.asarray(np.concatenate([np.sort(vid), np.zeros(pad, np.int32)])),
            jnp.asarray(np.concatenate([cb, np.zeros(pad, np.int32)])),
            jnp.asarray(np.concatenate([q, np.ones(pad, np.float32)])),
            len(variant2snp), len(names), 2.0,
        )
    )
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("power", [2.0, 1.0])
def test_mstep_matches_oracle(power):
    names, variant2snp, betas, vid, cb, q, n_barcodes, n_snps = _random_problem()
    n_variants = len(variant2snp)
    n_pg = len(L.doublet_penalties(len(names), 0.35))
    post = np.random.RandomState(5).rand(n_barcodes, n_pg).astype(np.float32)
    post /= post.sum(axis=1, keepdims=True)

    order = np.argsort(vid, kind="stable")
    ours = np.asarray(
        L.genotype_addition_from_posteriors(
            jnp.asarray(post), jnp.asarray(vid[order]), jnp.asarray(cb[order]), jnp.asarray(q[order]),
            n_variants, len(names), power, call_chunk=8192,
        )
    )
    ref = oracle_mstep(post, vid, cb, q, n_variants, len(names), power)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_molecule_calls_to_barcode_calls_matches_bruteforce():
    rng = np.random.RandomState(7)
    n = 5000
    vid = rng.randint(0, 50, n).astype(np.int32)
    snp_id = (vid // 2).astype(np.int32)
    cb = rng.randint(0, 40, n).astype(np.int32)
    q = rng.rand(n).astype(np.float32)
    mc = P.MoleculeCalls(
        variant_id=vid, snp_id=snp_id, compressed_cb=cb,
        molecule_id=np.arange(n, dtype=np.int32),
        p_base_wrong=q, p_molecule_aligned_wrong=np.full(n, 0.01, np.float32),
    )
    got = P.molecule_calls_to_barcode_calls(mc)
    ref = oracle_barcode_calls(vid, snp_id, cb, q)
    np.testing.assert_array_equal(got["variant_id"], ref["variant_id"])
    np.testing.assert_array_equal(got["snp_id"], ref["snp_id"])
    np.testing.assert_array_equal(got["compressed_cb"], ref["compressed_cb"])
    np.testing.assert_allclose(got["p_base_wrong"], ref["p_base_wrong"], rtol=1e-5)
    np.testing.assert_array_equal(got["barcode_variant_count"], ref["count"])

    # per-(snp, barcode) molecule counts
    for i in range(0, len(got), 257):
        mask = (got["snp_id"] == got["snp_id"][i]) & (got["compressed_cb"] == got["compressed_cb"][i])
        assert got["barcode_snp_count"][i] == got["barcode_variant_count"][mask].sum()


def test_device_pack_single_shard_roundtrip():
    rng = np.random.RandomState(11)
    n = 3000
    rec = np.recarray(n, dtype=P.BARCODE_CALLS_DTYPE)
    rec["variant_id"] = rng.randint(0, 100, n)
    rec["snp_id"] = rec["variant_id"] // 2
    rec["compressed_cb"] = rng.randint(0, 77, n)
    rec["p_base_wrong"] = rng.rand(n)
    rec["barcode_variant_count"] = 1
    rec["barcode_snp_count"] = 1
    dc = P.device_pack_barcode_calls(rec, n_barcodes=77, pad_multiple=1024)
    assert dc.cb_b.shape == dc.vid_b.shape == dc.q_b.shape
    assert len(dc.cb_b) % 1024 == 0
    # barcode-order: non-decreasing cb, padding has q == 1
    n_real = n
    assert np.all(np.diff(dc.cb_b[:n_real]) >= 0)
    assert np.all(dc.q_b[n_real:] == 1.0)
    # variant-order: sorted vid
    assert np.all(np.diff(dc.vid_v[:n_real]) >= 0)
    # contents match (as multisets of rows)
    orig = sorted(zip(rec["compressed_cb"], rec["variant_id"], rec["p_base_wrong"]))
    packed = sorted(zip(dc.cb_b[:n_real], dc.vid_b[:n_real], dc.q_b[:n_real]))
    assert orig == packed


def test_demultiplexer_parity_helpers():
    """Reference-named staticmethods produce oracle-identical results."""
    from demuxalot_tpu import Demultiplexer
    from demuxalot_tpu.ops import packing as P

    names, variant2snp, betas, vid, cb, q, n_barcodes, n_snps = _random_problem(n_calls=8000)
    gprob = Demultiplexer._compute_probs_from_betas(variant2snp, betas, 0.01)
    np.testing.assert_allclose(gprob, oracle_probs_from_betas(variant2snp, betas, 0.01),
                               rtol=1e-5, atol=1e-7)

    from oracle import iterate_pseudogenotypes

    got = list(Demultiplexer._iterate_genotypes_options(names, gprob, 0.35))
    ref = list(iterate_pseudogenotypes(names, gprob, 0.35))
    assert [(i, n) for i, n, _ in got] == [(i, n) for i, n, _ in ref]
    for (_, _, a), (_, _, b) in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6)

    rec = np.recarray(len(vid), dtype=P.BARCODE_CALLS_DTYPE)
    rec["variant_id"], rec["compressed_cb"], rec["p_base_wrong"] = vid, cb, q
    rec["snp_id"] = variant2snp[vid]
    rec["barcode_variant_count"] = 1
    rec["barcode_snp_count"] = 1
    logits, cols = Demultiplexer.compute_barcode_logits_using_barcode_calls(
        names, rec, 0.35, gprob, n_barcodes, len(names)
    )
    ref_logits, ref_cols = oracle_barcode_logits(names, gprob, vid, cb, q, n_barcodes, 0.35)
    assert cols == ref_cols
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-4, atol=5e-3)


def test_snp_aggregated_logits_matches_oracle():
    """Device per-SNP aggregation path == numpy reference math."""
    import jax.numpy as jnp
    from demuxalot_tpu.ops import likelihood as L
    from demuxalot_tpu.utils.lookup import FeatureLookup

    from oracle import oracle_snp_aggregated_logits

    rng = np.random.RandomState(7)
    n_variants, n_donors, n_barcodes, n_calls = 40, 5, 23, 500
    gp = rng.uniform(0.01, 0.99, size=(n_variants, n_donors)).astype(np.float32)
    mixing, _ = L.pseudogenotype_mixing([f"D{i}" for i in range(n_donors)], 0.3)
    vid = rng.randint(0, n_variants, n_calls).astype(np.int32)
    snp_id = (vid // 2).astype(np.int32)
    cb = rng.randint(0, n_barcodes, n_calls).astype(np.int32)
    q = rng.uniform(1e-5, 0.3, n_calls).astype(np.float32)

    groups = FeatureLookup(cb, snp_id)
    gid, counts = groups.compress(cb, snp_id)
    barcode_of_group, _ = groups.lookup_for_individual_features()
    order = np.argsort(gid, kind="stable")

    got = np.asarray(L.snp_aggregated_logits(
        jnp.asarray(gp), jnp.asarray(mixing),
        jnp.asarray(vid[order]), jnp.asarray(q[order]),
        jnp.asarray(gid[order].astype(np.int32)),
        jnp.asarray(barcode_of_group.astype(np.int32)),
        jnp.asarray(counts.astype(np.float32)),
        n_groups=groups.nvalues, n_barcodes=n_barcodes, compensation=0.5,
        call_chunk=128,  # force the chunked-scan path
    ))
    want = oracle_snp_aggregated_logits(gp, mixing, vid, q, cb, snp_id, n_barcodes)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_materialize_logits_and_probs_device_softmax():
    """Posterior frames come from the device softmax, read back as they are."""
    import jax
    import jax.numpy as jnp

    from demuxalot_tpu.models import demux as D

    rng = np.random.RandomState(3)
    logits_dev = jnp.asarray(rng.randn(257, 23).astype(np.float32) * 10)
    want = np.asarray(jax.nn.softmax(logits_dev, axis=-1))
    logits, probs = D._materialize_logits_and_probs(logits_dev)
    np.testing.assert_array_equal(logits, np.asarray(logits_dev))
    np.testing.assert_array_equal(probs, want)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)
