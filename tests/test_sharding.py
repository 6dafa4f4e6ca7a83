"""Multi-device tests on the virtual 8-device CPU mesh.

The sharded path must produce the same posteriors and learnt betas as the
single-device Demultiplexer.
"""
import jax
import numpy as np
import pytest

from demuxalot_tpu import BarcodeHandler, Demultiplexer
from demuxalot_tpu.parallel import ShardedDemultiplexer, make_mesh
from demuxalot_tpu.sim import generate_bam_file
from demuxalot_tpu.frontend.snp_counter import count_snps


@pytest.fixture(scope="module")
def small_problem(tmp_path_factory):
    np.random.seed(7)
    filename = str(tmp_path_factory.mktemp("bam") / "t.bam")
    filename, genotypes, _ids, barcode2donor_names = generate_bam_file(
        filename, n_genotypes=6, n_barcodes=200, n_reads_per_barcode=40,
        chromosome2length={"chr1": 800, "chr2": 800},
    )
    barcode_handler = BarcodeHandler(list(barcode2donor_names))
    calls = count_snps(
        filename,
        chromosome2positions=genotypes.get_chromosome2positions(),
        barcode_handler=barcode_handler,
        joblib_n_jobs=None,
        joblib_verbosity=0,
    )
    return genotypes, barcode_handler, calls


def test_mesh_has_8_devices():
    assert jax.device_count() == 8, "tests expect the virtual 8-device CPU mesh"


@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_sharded_predict_matches_single_device(small_problem, doublet_prior):
    genotypes, barcode_handler, calls = small_problem
    logits1, probs1 = Demultiplexer.predict_posteriors(
        calls, genotypes, barcode_handler, doublet_prior=doublet_prior
    )
    sharded = ShardedDemultiplexer(make_mesh())
    logits8, probs8 = sharded.predict_posteriors(
        calls, genotypes, barcode_handler, doublet_prior=doublet_prior
    )
    assert list(logits1.columns) == list(logits8.columns)
    np.testing.assert_allclose(logits8.values, logits1.values, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(probs8.values, probs1.values, atol=1e-5)
    # identical assignments
    assert (probs1.idxmax(axis=1) == probs8.idxmax(axis=1)).all()


def test_sharded_em_matches_single_device(small_problem):
    genotypes, barcode_handler, calls = small_problem
    learnt1, probs1 = Demultiplexer.learn_genotypes(
        calls, genotypes, barcode_handler, n_iterations=3
    )
    sharded = ShardedDemultiplexer(make_mesh())
    learnt8, probs8 = sharded.learn_genotypes(calls, genotypes, barcode_handler, n_iterations=3)

    np.testing.assert_allclose(probs8.values, probs1.values, atol=1e-4)
    np.testing.assert_allclose(
        learnt8.variant_betas, learnt1.variant_betas, rtol=1e-4, atol=1e-2
    )
    assert (probs1.idxmax(axis=1) == probs8.idxmax(axis=1)).all()


def test_sharded_anchored_damping_matches_single_device(small_problem):
    """damping="anchor" must behave identically on the sharded engine."""
    genotypes, barcode_handler, calls = small_problem
    ng = genotypes.clone()
    snp_ids = ng.get_snp_ids_for_variants()
    rng = np.random.RandomState(9)
    erased_rows = np.nonzero((rng.rand(snp_ids.max() + 1) < 0.9)[snp_ids])[0]
    ng.variant_betas[erased_rows, :] = 0

    learnt1, probs1 = Demultiplexer.learn_genotypes(
        calls, ng, barcode_handler, n_iterations=3, damping="anchor"
    )
    sharded = ShardedDemultiplexer(make_mesh())
    learnt8, probs8 = sharded.learn_genotypes(
        calls, ng, barcode_handler, n_iterations=3, damping="anchor"
    )
    np.testing.assert_allclose(probs8.values, probs1.values, atol=1e-4)
    np.testing.assert_allclose(
        learnt8.variant_betas, learnt1.variant_betas, rtol=1e-4, atol=1e-2
    )
    # erased variants received no addition on either engine
    assert np.all(learnt8.get_betas()[erased_rows] == ng.get_betas()[erased_rows])
    with pytest.raises(ValueError):
        sharded.learn_genotypes(calls, ng, barcode_handler, damping="bogus")


def test_sharded_em_with_prior_logits(small_problem):
    genotypes, barcode_handler, calls = small_problem
    empty = genotypes.clone()
    empty.variant_betas[:] = 0
    n_options = genotypes.n_genotypes
    rng = np.random.RandomState(0)
    prior = np.zeros((barcode_handler.n_barcodes, n_options), dtype=np.float32)
    labeled = rng.rand(barcode_handler.n_barcodes) < 0.5
    prior[labeled, rng.randint(0, n_options, labeled.sum())] = 100.0

    learnt1, probs1 = Demultiplexer.learn_genotypes(
        calls, empty, barcode_handler, n_iterations=2, barcode_prior_logits=prior
    )
    sharded = ShardedDemultiplexer(make_mesh())
    learnt8, probs8 = sharded.learn_genotypes(
        calls, empty, barcode_handler, n_iterations=2, barcode_prior_logits=prior
    )
    np.testing.assert_allclose(probs8.values, probs1.values, atol=1e-4)
    np.testing.assert_allclose(learnt8.variant_betas, learnt1.variant_betas, rtol=1e-4, atol=1e-2)


def test_sharded_pallas_estep_matches(small_problem):
    """The per-shard E-step kernel (interpreted on CPU) across 8 devices."""
    genotypes, barcode_handler, calls = small_problem
    logits1, probs1 = Demultiplexer.predict_posteriors(
        calls, genotypes, barcode_handler, doublet_prior=0.35
    )
    sharded = ShardedDemultiplexer(make_mesh())
    try:
        sharded.use_pallas = "interpret"
        logits8, probs8 = sharded.predict_posteriors(
            calls, genotypes, barcode_handler, doublet_prior=0.35
        )
        learnt8, probsL8 = sharded.learn_genotypes(calls, genotypes, barcode_handler, n_iterations=2)
    finally:
        sharded.use_pallas = None
    np.testing.assert_allclose(logits8.values, logits1.values, rtol=1e-4, atol=5e-3)
    assert (probs1.idxmax(axis=1) == probs8.idxmax(axis=1)).all()

    learnt1, probsL1 = Demultiplexer.learn_genotypes(calls, genotypes, barcode_handler, n_iterations=2)
    np.testing.assert_allclose(learnt8.variant_betas, learnt1.variant_betas, rtol=1e-4, atol=1e-2)


def test_sharded_scan_path(small_problem):
    """Force the chunked-scan code path (n_calls > call_chunk) under shard_map."""
    genotypes, barcode_handler, calls = small_problem
    learnt1, probs1 = Demultiplexer.learn_genotypes(calls, genotypes, barcode_handler, n_iterations=2)
    sharded = ShardedDemultiplexer(make_mesh())
    try:
        sharded.call_chunk = 256  # far below the call count
        learnt8, probs8 = sharded.learn_genotypes(calls, genotypes, barcode_handler, n_iterations=2)
    finally:
        sharded.call_chunk = type(sharded).call_chunk
    np.testing.assert_allclose(probs8.values, probs1.values, atol=1e-4)
    np.testing.assert_allclose(learnt8.variant_betas, learnt1.variant_betas, rtol=1e-4, atol=1e-2)


def test_put_row_shards_assembles_global_array():
    """Per-process row blocks assemble into the right global sharded array."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from demuxalot_tpu.parallel.mesh import make_mesh, put_row_shards

    mesh = make_mesh()
    n = mesh.devices.size
    shd = NamedSharding(mesh, PartitionSpec("barcodes"))
    blocks = {k: np.full((3, 4), k, dtype=np.float32) for k in range(n)}
    out = put_row_shards({k: b for k, b in blocks.items()}, shd, (3 * n, 4))
    expected = np.concatenate([blocks[k] for k in range(n)])
    np.testing.assert_array_equal(np.asarray(out), expected)

    # flat 1-D layout
    flat_blocks = {k: np.arange(5, dtype=np.int32) + 10 * k for k in range(n)}
    out1 = put_row_shards(flat_blocks, shd, (5 * n,))
    np.testing.assert_array_equal(
        np.asarray(out1), np.concatenate([flat_blocks[k] for k in range(n)])
    )


def test_shard_subset_layouts_match_full():
    """Building only a subset of shards yields the same rows as the full build."""
    from demuxalot_tpu.ops import packing as P

    rng = np.random.RandomState(3)
    n_calls, n_barcodes, n_shards = 5000, 256, 4
    cb = np.sort(rng.randint(0, n_barcodes, n_calls)).astype(np.int32)
    vid = rng.randint(0, 500, n_calls).astype(np.int32)
    q = rng.uniform(1e-4, 0.5, n_calls).astype(np.float32)

    # shard-local kernel runs (what each process builds for its own shards)
    per_shard = n_barcodes // n_shards
    counts = np.bincount(cb // per_shard, minlength=n_shards)
    full_dev = P.device_pack_columns(cb, vid, q, n_barcodes, n_shards=n_shards)
    sub_dev = P.device_pack_columns(
        cb, vid, q, n_barcodes, n_shards=n_shards, shard_ids=[1, 3],
        per_shard_calls_floor=full_dev.per_shard_calls,
    )

    def unplaced(stacked):
        return stacked

    full = ShardedDemultiplexer._kernel_runs(full_dev, counts, unplaced)
    subset = ShardedDemultiplexer._kernel_runs(sub_dev, counts[[1, 3]], unplaced)
    for got, want in zip(subset, full):  # offsets, vid, q
        assert got.shape[1:] == want.shape[1:]
        np.testing.assert_array_equal(got[0], want[1])
        np.testing.assert_array_equal(got[1], want[3])
    np.testing.assert_array_equal(full[0][:, per_shard], counts)

    rec = np.recarray(n_calls, dtype=P.BARCODE_CALLS_DTYPE)
    rec["variant_id"], rec["compressed_cb"], rec["p_base_wrong"] = vid, cb, q
    dev_full = P.device_pack_barcode_calls(rec, n_barcodes, n_shards=n_shards, pad_multiple=8)
    dev_sub = P.device_pack_barcode_calls(
        rec, n_barcodes, n_shards=n_shards, pad_multiple=8,
        shard_ids=[2], per_shard_calls_floor=dev_full.per_shard_calls,
    )
    w = dev_full.per_shard_calls
    np.testing.assert_array_equal(dev_sub.vid_b, dev_full.vid_b[2 * w : 3 * w])
    np.testing.assert_array_equal(dev_sub.q_v, dev_full.q_v[2 * w : 3 * w])


@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_kernel_engines_match_xla_engine(small_problem, doublet_prior):
    """Both engines on the E-step kernel (interpreted) == the XLA single-device path."""
    genotypes, barcode_handler, calls = small_problem
    logits_x, probs_x = Demultiplexer.predict_posteriors(
        calls, genotypes, barcode_handler, doublet_prior=doublet_prior
    )
    learnt_x, em_x = Demultiplexer.learn_genotypes(
        calls, genotypes, barcode_handler, n_iterations=2, doublet_prior=doublet_prior
    )
    sharded = ShardedDemultiplexer(make_mesh())
    sharded.use_pallas = "interpret"
    try:
        Demultiplexer.use_pallas = "interpret"
        logits_k, probs_k = Demultiplexer.predict_posteriors(
            calls, genotypes, barcode_handler, doublet_prior=doublet_prior
        )
        learnt_k, em_k = Demultiplexer.learn_genotypes(
            calls, genotypes, barcode_handler, n_iterations=2, doublet_prior=doublet_prior
        )
        compact = Demultiplexer.predict_posteriors_compact(
            calls, genotypes, barcode_handler, doublet_prior=doublet_prior, k=2
        )
    finally:
        Demultiplexer.use_pallas = None
    logits_s, probs_s = sharded.predict_posteriors(
        calls, genotypes, barcode_handler, doublet_prior=doublet_prior
    )
    learnt_s, em_s = sharded.learn_genotypes(
        calls, genotypes, barcode_handler, n_iterations=2, doublet_prior=doublet_prior
    )
    for logits in (logits_k, logits_s):
        assert list(logits.columns) == list(logits_x.columns)
        np.testing.assert_allclose(logits.values, logits_x.values, rtol=1e-5, atol=1e-4)
    for probs in (probs_k, probs_s, em_k, em_s):
        np.testing.assert_allclose(probs.values.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs_k.values, probs_x.values, atol=1e-5)
    np.testing.assert_allclose(em_k.values, em_x.values, atol=1e-4)
    np.testing.assert_allclose(em_s.values, em_x.values, atol=1e-4)
    for learnt in (learnt_k, learnt_s):
        np.testing.assert_allclose(
            learnt.variant_betas, learnt_x.variant_betas, rtol=1e-4, atol=1e-2
        )
    np.testing.assert_array_equal(compact.assignment, logits_k.values.argmax(axis=1))


def test_use_pallas_true_raises_off_gpu(small_problem):
    """Asking for the compiled kernel where it cannot compile raises, never falls back."""
    genotypes, barcode_handler, calls = small_problem
    sharded = ShardedDemultiplexer(make_mesh())
    sharded.use_pallas = True
    with pytest.raises(RuntimeError, match="only for a GPU"):
        sharded.predict_posteriors(calls, genotypes, barcode_handler)
    try:
        Demultiplexer.use_pallas = True
        with pytest.raises(RuntimeError, match="only for a GPU"):
            Demultiplexer.predict_posteriors(calls, genotypes, barcode_handler)
    finally:
        Demultiplexer.use_pallas = None


def test_sharded_accepts_packed_calls(small_problem):
    """The sharded engine unwraps a PackedCalls dataset (pack-level reuse)."""
    from demuxalot_tpu import PackedCalls

    genotypes, barcode_handler, calls = small_problem
    packed = PackedCalls(calls, genotypes)
    sharded = ShardedDemultiplexer(make_mesh())
    logits_dict, probs_dict = sharded.predict_posteriors(
        calls, genotypes, barcode_handler, doublet_prior=0.35
    )
    logits_packed, probs_packed = sharded.predict_posteriors(
        packed, genotypes, barcode_handler, doublet_prior=0.35
    )
    np.testing.assert_array_equal(logits_dict.values, logits_packed.values)
    np.testing.assert_array_equal(probs_dict.values, probs_packed.values)

    learnt_d, probs_d = sharded.learn_genotypes(
        calls, genotypes, barcode_handler, n_iterations=2
    )
    learnt_p, probs_p = sharded.learn_genotypes(
        packed, genotypes, barcode_handler, n_iterations=2
    )
    np.testing.assert_array_equal(probs_d.values, probs_p.values)
    np.testing.assert_array_equal(learnt_d.get_betas(), learnt_p.get_betas())


def test_sharded_layout_cache_zero_retile(small_problem):
    """Predict-after-learn on one PackedCalls re-lays out nothing.

    The shard layouts cache on the dataset; the E-step tiling is sized at
    the donor count's max pseudo-genotype width so learn(doublet_prior=0)
    and predict(0.35) share one entry, and results stay identical to the
    per-call path.
    """
    from demuxalot_tpu import PackedCalls

    genotypes, barcode_handler, calls = small_problem
    packed = PackedCalls(calls, genotypes)
    sharded = ShardedDemultiplexer(make_mesh())

    learnt, probs_em = sharded.learn_genotypes(
        packed, genotypes, barcode_handler, n_iterations=2
    )
    misses_after_learn = sharded.layout_cache_misses
    assert misses_after_learn >= 1

    logits, probs = sharded.predict_posteriors(
        packed, genotypes, barcode_handler, doublet_prior=0.35
    )
    # the predict entry point reused the learn-built E-step layout: zero
    # new tilings, one cache hit
    assert sharded.layout_cache_misses == misses_after_learn
    assert sharded.layout_cache_hits >= 1

    # a second learn re-tiles nothing either (E-step AND M-step entries hit)
    hits_before = sharded.layout_cache_hits
    sharded.learn_genotypes(packed, genotypes, barcode_handler, n_iterations=2)
    assert sharded.layout_cache_misses == misses_after_learn
    assert sharded.layout_cache_hits >= hits_before + 2

    # results identical to the per-call-dict flow on a fresh engine
    fresh = ShardedDemultiplexer(make_mesh())
    logits_d, probs_d = fresh.predict_posteriors(
        calls, genotypes, barcode_handler, doublet_prior=0.35
    )
    np.testing.assert_array_equal(logits.values, logits_d.values)


def test_sharded_stage_timings_hook(small_problem):
    """STAGE_TIMINGS instrumentation covers the sharded entry points too."""
    from demuxalot_tpu.models import demux as demux_mod

    genotypes, barcode_handler, calls = small_problem
    sharded = ShardedDemultiplexer(make_mesh())
    demux_mod.STAGE_TIMINGS = {}
    try:
        _lg, probs_t = sharded.predict_posteriors(
            calls, genotypes, barcode_handler, doublet_prior=0.35
        )
        predict_detail = demux_mod.STAGE_TIMINGS
        demux_mod.STAGE_TIMINGS = {}
        _learnt, probs_em = sharded.learn_genotypes(
            calls, genotypes, barcode_handler, n_iterations=2
        )
        learn_detail = demux_mod.STAGE_TIMINGS
        demux_mod.STAGE_TIMINGS = None
        for key in ("pack_s", "layout_s", "upload_flush_s", "forward_s",
                    "materialize_s", "h2d_bytes", "d2h_logits_bytes"):
            assert key in predict_detail, (key, predict_detail)
        for key in ("pack_s", "layout_s", "upload_flush_s", "device_loop_s",
                    "materialize_s", "h2d_bytes", "d2h_addition_bytes"):
            assert key in learn_detail, (key, learn_detail)

        # instrumentation must not change results
        demux_mod.STAGE_TIMINGS = None
        _lg2, probs_u = sharded.predict_posteriors(
            calls, genotypes, barcode_handler, doublet_prior=0.35
        )
        np.testing.assert_array_equal(probs_t.values, probs_u.values)
    finally:
        demux_mod.STAGE_TIMINGS = None


def test_sharded_compact_matches_full(small_problem):
    """Sharded compact output == full sharded frames (same contract)."""
    genotypes, barcode_handler, calls = small_problem
    from demuxalot_tpu import PackedCalls

    packed = PackedCalls(calls, genotypes)
    sharded = ShardedDemultiplexer(make_mesh())
    logits_df, probs_df = sharded.predict_posteriors(
        packed, genotypes, barcode_handler, doublet_prior=0.35
    )
    compact = sharded.predict_posteriors_compact(
        packed, genotypes, barcode_handler, doublet_prior=0.35, k=3
    )
    full = logits_df.values
    np.testing.assert_array_equal(compact.assignment, full.argmax(axis=1))
    rows = np.arange(full.shape[0])[:, None]
    np.testing.assert_array_equal(
        compact.top_logits, full[rows, compact.top_index]
    )
    top1 = probs_df.values[rows[:, 0], compact.assignment]
    np.testing.assert_allclose(compact.top_probs[:, 0], top1, atol=1e-5)
    assert compact.bytes_moved < full.nbytes
    assert list(compact.to_dataframe().index) == list(logits_df.index)

    # bf16 frame on request, within 1 bf16 ulp of the full f32 frame
    compact_bf = sharded.predict_posteriors_compact(
        packed, genotypes, barcode_handler, doublet_prior=0.35, k=3,
        include_logits=True,
    )
    bf = compact_bf.logits_bf16.astype(np.float32)
    ulp = np.maximum(np.abs(full) * 2.0**-7, np.finfo(np.float32).tiny)
    assert (np.abs(bf - full) <= ulp).all()
    assert compact_bf.logits_dataframe().shape == logits_df.shape


def test_sharded_auto_damping_packs_once(small_problem):
    """damping='auto' shares one pack + shard layouts between its two runs."""
    genotypes, barcode_handler, calls = small_problem
    sharded = ShardedDemultiplexer(make_mesh())
    learnt, probs = sharded.learn_genotypes(
        calls, genotypes, barcode_handler, n_iterations=2, damping="auto"
    )
    assert probs.attrs["damping_selected"] in (None, "anchor")
    # two EM runs, but the second hits the cache built by the first:
    # exactly one estep + one mstep layout build in total
    assert sharded.layout_cache_misses == 2, (
        sharded.layout_cache_misses, sharded.layout_cache_hits)
    assert sharded.layout_cache_hits >= 2
