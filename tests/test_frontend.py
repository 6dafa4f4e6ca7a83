"""Frontend unit tests: consensus rules, plugins, multi-BAM RG counting."""
import numpy as np
import pytest

from demuxalot_tpu import BarcodeHandler
from demuxalot_tpu.bamio import AlignedRead, BamWriter, index_bam, sort_bam
from demuxalot_tpu.frontend.snp_counter import (
    ChromosomeSNPLookup,
    consensus_call_molecule,
    count_snps,
)


def _read(start, seq, qual=30, as_score=None, cb="AAA-1", ub="ACGTACGTAC", nh=1):
    a = AlignedRead()
    a.query_name = "r"
    a.flag = 0
    a.reference_id = 0
    a.reference_start = start
    a.mapping_quality = 60
    a.query_sequence = seq
    a.cigar = ((0, len(seq)),)
    a.query_qualities = [qual] * len(seq) if np.isscalar(qual) else list(qual)
    a.tags = (
        ("NH", nh), ("AS", as_score if as_score is not None else len(seq) - 2),
        ("CB", cb), ("UB", ub), ("RG", "L1"),
    )
    return a


class TestConsensusRules:
    lookup = ChromosomeSNPLookup(np.array([5, 10, 15]))

    def test_single_read(self):
        p_mis, calls = consensus_call_molecule([(_read(0, "A" * 20, qual=30), 0.01)], self.lookup)
        assert p_mis == 0.01
        expected_p = 0.1 ** (0.1 * 30)
        assert sorted(calls) == [(5, "A", pytest.approx(expected_p)),
                                 (10, "A", pytest.approx(expected_p)),
                                 (15, "A", pytest.approx(expected_p))]

    def test_quality_capped_at_40(self):
        _p, calls = consensus_call_molecule([(_read(0, "A" * 20, qual=60), 0.01)], self.lookup)
        assert calls[0][2] == pytest.approx(0.1 ** (0.1 * 40))

    def test_agreeing_reads_multiply(self):
        reads = [(_read(0, "A" * 20, qual=30), 0.01), (_read(1, "A" * 19, qual=20), 0.01)]
        p_mis, calls = consensus_call_molecule(reads, self.lookup)
        assert p_mis == pytest.approx(0.01 * 0.01)
        by_pos = dict((pos, p) for pos, _b, p in calls)
        assert by_pos[5] == pytest.approx(0.1 ** (0.1 * 30) * 0.1 ** (0.1 * 20))

    def test_conflict_close_quality_no_call(self):
        # same position, different bases, similar quality -> ambiguous -> no call
        reads = [(_read(0, "A" * 20, qual=30), 0.01), (_read(0, "C" * 20, qual=30), 0.01)]
        # give the second read a different AS so it's not a complete duplicate
        reads[1][0].set_tag("AS", 17)
        _p, calls = consensus_call_molecule(reads, self.lookup)
        assert calls == []

    def test_conflict_resolved_by_1000x_cutoff(self):
        # 0.1^(0.1*40) vs 0.1^(0.1*3): ratio > 1000 -> keep the good one
        reads = [(_read(0, "A" * 20, qual=40), 0.01), (_read(0, "C" * 20, qual=3), 0.01)]
        reads[1][0].set_tag("AS", 17)
        _p, calls = consensus_call_molecule(reads, self.lookup)
        assert len(calls) == 3
        assert all(b == "A" for _pos, b, _p in calls)

    def test_complete_duplicates_skipped(self):
        # identical (start, end, AS): second read ignored entirely
        reads = [(_read(0, "A" * 20, qual=30), 0.01), (_read(0, "C" * 20, qual=30), 0.01)]
        p_mis, calls = consensus_call_molecule(reads, self.lookup)
        assert p_mis == pytest.approx(0.01)  # only one read contributes
        assert all(b == "A" for _pos, b, _p in calls)
        assert len(calls) == 3


def test_bd_rhapsody_plugin_uses_ma_tag():
    from demuxalot_tpu.frontend.bd_rhapsody import parse_read as bd_parse
    from demuxalot_tpu.frontend.cellranger import parse_read as cr_parse
    from demuxalot_tpu.utils import hash_string

    read = _read(0, "A" * 20)
    read.set_tag("MA", "TTTTT")
    assert bd_parse(read) == (0.01, hash_string("TTTTT"))
    assert cr_parse(read) == (0.01, hash_string("ACGTACGTAC"))

    read2 = _read(0, "A" * 20, nh=2)
    assert cr_parse(read2) is None
    read3 = _read(0, "A" * 20, as_score=5)
    assert cr_parse(read3) is None


def test_classify_read_labels_first_disqualifier():
    from demuxalot_tpu.frontend import cellranger as cr

    assert cr.classify_read(_read(0, "A" * 20)) == cr.USABLE
    assert cr.classify_read(_read(0, "A" * 20, as_score=5)) == cr.SCORE_BELOW_FLOOR
    assert cr.classify_read(_read(0, "A" * 20, nh=3)) == cr.MULTIMAPPED

    no_umi = _read(0, "A" * 20)
    no_umi.tags = tuple(t for t in no_umi.tags if t[0] != "UB")
    assert cr.classify_read(no_umi) == cr.MISSING_UMI

    low_mapq = _read(0, "A" * 20)
    low_mapq.mapping_quality = 3
    assert cr.classify_read(low_mapq) == cr.LOW_MAPQ
    # parse_read must agree with the verdict on accept/reject
    assert cr.parse_read(low_mapq) is None
    assert cr.parse_read(_read(0, "A" * 20)) is not None
    # evaluation order: a read failing several checks gets the FIRST label
    multi_bad = _read(0, "A" * 20, as_score=5, nh=3)
    assert cr.classify_read(multi_bad) == cr.SCORE_BELOW_FLOOR


def _write_bam(path, reads, ln=500):
    with BamWriter(path, {"HD": {"VN": "1.0"}, "SQ": [dict(LN=ln, SN="chr1")]}) as w:
        for r in reads:
            w.write(r)
    sort_bam(path, path)
    index_bam(path)


def test_multibam_rg_counting(tmp_path):
    """dict-of-bamfiles input keyed by RG with (barcode, RG) identities."""
    bam_a = str(tmp_path / "a.bam")
    bam_b = str(tmp_path / "b.bam")
    # same barcode string in both files — RG keeps them distinct
    _write_bam(bam_a, [_read(i, "A" * 50, cb="SHARED-1", ub=f"UMI{i:05}A43") for i in range(40)])
    _write_bam(bam_b, [_read(i, "C" * 50, cb="SHARED-1", ub=f"UMI{i:05}B77") for i in range(40)])

    handler = BarcodeHandler(["SHARED-1", "SHARED-1"], RG_tags=["fileA", "fileB"])
    positions = {"chr1": np.array([10, 20])}
    calls = count_snps(
        {"fileA": bam_a, "fileB": bam_b},
        positions, handler, joblib_n_jobs=None, joblib_verbosity=0,
    )
    chr1 = calls["chr1"]
    chr1.minimize_memory_footprint()
    assert chr1.n_snp_calls > 0
    cbs = set(chr1.molecules["compressed_cb"][chr1.snp_calls["molecule_index"]])
    assert cbs == {0, 1}, "both (barcode, RG) identities should appear"
    # base composition: index of ('SHARED-1','fileA') observed A, fileB observed C
    idx_a = handler.barcode2index[("SHARED-1", "fileA")]
    for mol_idx, _pos, base, _q in chr1.snp_calls:
        cb = chr1.molecules["compressed_cb"][mol_idx]
        assert base == (0 if cb == idx_a else 1)


def test_counting_in_spawned_workers_matches_inline(tmp_path):
    """Region tasks fanned out over spawned processes count what inline counting does."""
    bam_a = str(tmp_path / "a.bam")
    bam_b = str(tmp_path / "b.bam")
    _write_bam(bam_a, [_read(i, "A" * 50, cb=f"BC{i % 4}-1", ub=f"UMI{i:05}A43") for i in range(60)])
    _write_bam(bam_b, [_read(i, "C" * 50, cb=f"BC{i % 4}-1", ub=f"UMI{i:05}B77") for i in range(60)])
    handler = BarcodeHandler([f"BC{i}-1" for i in range(4)] * 2, RG_tags=["a"] * 4 + ["b"] * 4)
    positions = {"chr1": np.array([10, 20, 45])}
    bams = {"a": bam_a, "b": bam_b}
    inline = count_snps(bams, positions, handler, joblib_n_jobs=None, joblib_verbosity=0, native=False)
    spawned = count_snps(bams, positions, handler, joblib_n_jobs=2, joblib_verbosity=0, native=False)
    assert set(inline) == set(spawned) == {"chr1"}
    for calls in (inline["chr1"], spawned["chr1"]):
        calls.minimize_memory_footprint()
    assert inline["chr1"].n_snp_calls > 0
    np.testing.assert_array_equal(spawned["chr1"].molecules, inline["chr1"].molecules)
    np.testing.assert_array_equal(spawned["chr1"].snp_calls, inline["chr1"].snp_calls)


def test_diagnostics_helpers(tmp_path):
    from demuxalot_tpu.utils import compute_qualities, summarize_counted_SNPs
    import pandas as pd

    bam = str(tmp_path / "d.bam")
    _write_bam(bam, [_read(i % 100, "A" * 50, cb=f"BC{i % 3}-1", ub=f"UMI{i:07}123") for i in range(60)])
    handler = BarcodeHandler([f"BC{i}-1" for i in range(3)])
    calls = count_snps(bam, {"chr1": np.array([10, 60])}, handler,
                       joblib_n_jobs=None, joblib_verbosity=0)
    table = summarize_counted_SNPs(calls, show_plot=False)
    assert table.loc["chr1", "n_molecules"] > 0

    probs = pd.DataFrame(
        [[0.9, 0.1], [0.2, 0.8], [0.5, 0.5]],
        index=["b1", "b2", "b3"], columns=["D1", "D2"],
    )
    metrics = compute_qualities(probs, {"b1": ["D1"], "b2": ["D2"], "b3": ["D1", "D2"]})
    assert metrics["accuracy"] == 1.0
    assert metrics["logloss"] > 0


def test_snp_counts_serialization(tmp_path):
    from demuxalot_tpu.frontend.snp_counter import load_snp_counts, save_snp_counts

    bam = str(tmp_path / "s.bam")
    _write_bam(bam, [_read(i % 100, "A" * 50, cb="BC0-1", ub=f"UMI{i:07}999") for i in range(30)])
    handler = BarcodeHandler(["BC0-1"])
    calls = count_snps(bam, {"chr1": np.array([10, 60])}, handler,
                       joblib_n_jobs=None, joblib_verbosity=0)
    save_snp_counts(calls, tmp_path / "counts")
    back = load_snp_counts(tmp_path / "counts")
    assert set(back) == set(calls)
    for chrom in calls:
        np.testing.assert_array_equal(back[chrom].molecules, calls[chrom].molecules)
        np.testing.assert_array_equal(back[chrom].snp_calls, calls[chrom].snp_calls)


def test_lookup_scales_to_human_chromosome():
    """250Mb contig, >70k SNPs: bounded memory, no integer-width ceiling.

    Regression guard for the reference's chromosome-length uint16 cumsum
    (wraps past 65535 SNPs, allocates ~500MB for chr1); our index is a
    sorted array + binary search.
    """
    rng = np.random.RandomState(0)
    contig_length = 250_000_000
    positions = np.unique(rng.randint(0, contig_length, size=120_000))
    assert len(positions) > 70_000
    lookup = ChromosomeSNPLookup(positions)
    # memory is O(n_snps), not O(contig length)
    assert lookup.positions.nbytes < 2_000_000

    # interval queries agree with a brute-force check, far past 2**16 SNPs
    for start, end in [(0, 10), (contig_length - 10, contig_length),
                       (int(positions[90_000]), int(positions[90_000]) + 1),
                       (int(positions[-1]) + 1, contig_length)]:
        expected = bool(((positions >= start) & (positions < end)).any())
        assert lookup.snips_exist(start, end) == expected

    # base extraction works at quarter-billion coordinates
    target = int(positions[100_000])
    read = _read(target - 5, "ACGTACGTACGT")
    p_mis, calls = consensus_call_molecule([(read, 0.01)], lookup)
    assert any(pos == target for pos, _b, _q in calls)
