"""The fused E-step kernel (``ops.estep_kernel``) against the numpy oracle.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``),
which executes the same kernel body; ``gpu``-marked tests run the compiled
kernel and skip where JAX finds no GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from demuxalot_tpu.ops import estep_kernel as K
from demuxalot_tpu.ops import likelihood as L
from oracle import oracle_barcode_logits

RUN = K.FOLD * K.CHUNK  # calls one loop step of the kernel consumes


def _calls(rng, distribution, n_barcodes, n_variants, mean_calls=20):
    """Barcode-sorted (cb, vid, q) with a chosen calls-per-barcode shape."""
    if distribution == "uniform":
        counts = rng.randint(mean_calls // 2, mean_calls * 3 // 2 + 1, n_barcodes)
    elif distribution == "heavy":
        counts = rng.geometric(1.0 / mean_calls, n_barcodes)
        counts[rng.randint(n_barcodes)] = 5 * RUN + 3  # one barcode spans many steps
    elif distribution == "empty":
        counts = rng.randint(0, 2 * mean_calls, n_barcodes)
        counts[rng.rand(n_barcodes) < 0.4] = 0
        counts[0] = counts[-1] = 0
    else:
        raise ValueError(distribution)
    cb = np.repeat(np.arange(n_barcodes), counts).astype(np.int32)
    vid = rng.randint(0, n_variants, len(cb)).astype(np.int32)
    q = rng.uniform(1e-5, 0.3, len(cb)).astype(np.float32)
    return cb, vid, q


def _kernel(gp, names, prior, cb, vid, q, n_barcodes, **build):
    mixing, _ = L.pseudogenotype_mixing(names, prior)
    runs = K.CallRuns.build(cb, vid, q, n_barcodes, **build)
    return np.asarray(K.estep_logits(
        jnp.asarray(gp), jnp.asarray(L.doublet_penalties(len(names), prior)),
        jnp.asarray(runs.offsets), jnp.asarray(runs.vid), jnp.asarray(runs.q),
        n_barcodes=n_barcodes, doublets=K.check_mixing(mixing), interpret=True,
    ))


@pytest.mark.parametrize("distribution", ["uniform", "heavy", "empty"])
@pytest.mark.parametrize("n_donors", [1, 2, 8, 32])
@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_kernel_matches_oracle(doublet_prior, n_donors, distribution):
    rng = np.random.RandomState(n_donors * 10 + int(doublet_prior * 100))
    n_barcodes, n_variants = 2 * K.TILE_ROWS + 3, 150
    names = [f"D{i}" for i in range(n_donors)]
    gp = rng.uniform(0.01, 0.99, (n_variants, n_donors)).astype(np.float32)
    cb, vid, q = _calls(rng, distribution, n_barcodes, n_variants)
    got = _kernel(gp, names, doublet_prior, cb, vid, q, n_barcodes)
    want, _ = oracle_barcode_logits(names, gp, vid, cb, q, n_barcodes, doublet_prior)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_barcodes,calls_per_barcode,n_donors", [
    (K.TILE_ROWS, RUN, K.BLOCK_DONORS),  # every size exactly one block
    (K.TILE_ROWS + 1, RUN - 1, K.BLOCK_DONORS + 1),  # one past / one short
    (K.TILE_ROWS - 1, RUN + 1, K.BLOCK_DONORS - 1),
    (2 * K.TILE_ROWS, 2 * RUN, 2 * K.BLOCK_DONORS),
    (1, 1, 3),
    (3, K.CHUNK, 2 * K.BLOCK_DONORS + 1),
])
def test_kernel_tile_and_block_boundaries(n_barcodes, calls_per_barcode, n_donors):
    rng = np.random.RandomState(n_barcodes + calls_per_barcode + n_donors)
    names = [f"D{i}" for i in range(n_donors)]
    n_variants = 64
    gp = rng.uniform(0.01, 0.99, (n_variants, n_donors)).astype(np.float32)
    cb = np.repeat(np.arange(n_barcodes), calls_per_barcode).astype(np.int32)
    vid = rng.randint(0, n_variants, len(cb)).astype(np.int32)
    q = rng.uniform(1e-5, 0.3, len(cb)).astype(np.float32)
    got = _kernel(gp, names, 0.35, cb, vid, q, n_barcodes)
    want, _ = oracle_barcode_logits(names, gp, vid, cb, q, n_barcodes, 0.35)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_padding_calls_are_exact_noops(doublet_prior):
    """Calls with q = 1 and a longer padded stream change no bit of the output."""
    rng = np.random.RandomState(5)
    n_barcodes, n_variants, n_donors = 13, 80, 5
    names = [f"D{i}" for i in range(n_donors)]
    gp = rng.uniform(0.01, 0.99, (n_variants, n_donors)).astype(np.float32)
    cb, vid, q = _calls(rng, "uniform", n_barcodes, n_variants)
    base = _kernel(gp, names, doublet_prior, cb, vid, q, n_barcodes)

    longer = _kernel(gp, names, doublet_prior, cb, vid, q, n_barcodes,
                     n_calls_padded=len(cb) + 3 * RUN + 5)
    np.testing.assert_array_equal(longer, base)

    # q = 1 calls inside every run: factor exactly 1, log term exactly 0
    extra_cb = np.repeat(np.arange(n_barcodes), 7).astype(np.int32)
    order = np.argsort(np.concatenate([cb, extra_cb]), kind="stable")
    padded = _kernel(
        gp, names, doublet_prior,
        np.concatenate([cb, extra_cb])[order],
        np.concatenate([vid, rng.randint(0, n_variants, len(extra_cb))])[order].astype(np.int32),
        np.concatenate([q, np.ones(len(extra_cb), np.float32)])[order],
        n_barcodes,
    )
    # the fold groups other factors together, so equality is to rounding
    np.testing.assert_allclose(padded, base, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n_barcodes,counts", [
    (5, [3, 0, 2, 0, 1]),
    (1, [0]),
    (K.TILE_ROWS, [1] * K.TILE_ROWS),
    (K.TILE_ROWS + 2, [0] * (K.TILE_ROWS + 1) + [4]),
])
def test_call_runs_layout(n_barcodes, counts):
    cb = np.repeat(np.arange(n_barcodes), counts).astype(np.int32)
    vid = np.arange(len(cb), dtype=np.int32) + 1
    q = np.full(len(cb), 0.25, np.float32)
    runs = K.CallRuns.build(cb, vid, q, n_barcodes)
    assert runs.n_barcodes == n_barcodes
    assert runs.n_barcodes_padded % K.TILE_ROWS == 0
    assert runs.n_barcodes_padded >= n_barcodes
    # offsets are the host prefix sum of the runs; padded barcodes are empty
    want = np.concatenate([[0], np.cumsum(counts)])
    np.testing.assert_array_equal(runs.offsets[: n_barcodes + 1], want)
    assert np.all(runs.offsets[n_barcodes:] == len(cb))
    # the stream carries one loop step of padding: vid 0, q 1
    assert len(runs.vid) == len(runs.q) == len(cb) + RUN
    np.testing.assert_array_equal(runs.vid[: len(cb)], vid)
    assert np.all(runs.vid[len(cb):] == 0) and np.all(runs.q[len(cb):] == 1.0)


@pytest.mark.parametrize("cb,message", [
    ([0, 2, 1], "sorted"),
    ([0, 1, 9], "out of range"),
    ([-1, 0, 1], "out of range"),
])
def test_call_runs_rejects_bad_barcodes(cb, message):
    cb = np.asarray(cb, np.int32)
    with pytest.raises(ValueError, match=message):
        K.CallRuns.build(cb, np.zeros_like(cb), np.zeros(len(cb), np.float32), 4)


@pytest.mark.parametrize("n_donors", [1, 5, K.BLOCK_DONORS, K.BLOCK_DONORS + 1, 32, 33])
@pytest.mark.parametrize("doublets", [False, True])
def test_pair_tiles_cover_each_column_once(n_donors, doublets):
    """The tiles' in-range cells on or above the diagonal are the columns."""
    cells = []
    for i0, j0 in K.pair_tiles(n_donors, doublets):
        for i in range(i0, min(i0 + K.BLOCK_DONORS, n_donors)):
            if doublets:
                cells += [(i, j) for j in range(max(i, j0), min(j0 + K.BLOCK_DONORS, n_donors))]
            else:
                cells.append((i, i))
    want = [(i, i) for i in range(n_donors)]
    if doublets:
        want += [(i, j) for i in range(n_donors) for j in range(i + 1, n_donors)]
    assert sorted(cells) == sorted(want)


@pytest.mark.parametrize("n_donors", [1, 2, 7])
def test_check_mixing(n_donors):
    names = [f"D{i}" for i in range(n_donors)]
    singlets, _ = L.pseudogenotype_mixing(names, 0.0)
    assert K.check_mixing(singlets) is False
    with_pairs, _ = L.pseudogenotype_mixing(names, 0.35)
    assert K.check_mixing(with_pairs) is (n_donors > 1)
    shuffled = with_pairs[:, ::-1] if with_pairs.shape[1] > 1 else with_pairs * 0.5
    with pytest.raises(ValueError, match="canonical"):
        K.check_mixing(shuffled)


@pytest.mark.parametrize("flag,want", [
    (None, (False, False)),  # XLA off the GPU
    (False, (False, False)),
    ("interpret", (True, True)),
])
def test_resolve_use_pallas_on_cpu(flag, want):
    assert jax.default_backend() == "cpu"
    assert K.resolve_use_pallas(flag) == want


def test_compiled_kernel_refused_off_gpu():
    """No silent interpretation: asking for the compiled kernel on a CPU raises."""
    with pytest.raises(RuntimeError, match="only for a GPU"):
        K.resolve_use_pallas(True)
    runs = K.CallRuns.build(np.zeros(3, np.int32), np.zeros(3, np.int32),
                            np.full(3, 0.1, np.float32), 1)
    with pytest.raises(RuntimeError, match="only for a GPU"):
        K.estep_logits(
            jnp.full((4, 2), 0.5), jnp.zeros(3), jnp.asarray(runs.offsets),
            jnp.asarray(runs.vid), jnp.asarray(runs.q), n_barcodes=1, doublets=True,
        )


@pytest.mark.parametrize("n_barcodes,n_variants", [(2**22, 100), (64, 2**26)])
def test_kernel_refuses_tables_past_int32_offsets(n_barcodes, n_variants):
    """Shapes whose element offsets overflow int32 raise at trace time."""
    n_donors = 64
    n_pg = n_donors * (n_donors + 1) // 2
    struct = jax.ShapeDtypeStruct
    args = (
        struct((n_variants, n_donors), jnp.float32), struct((n_pg,), jnp.float32),
        struct((n_barcodes + 1,), jnp.int32), struct((RUN,), jnp.int32),
        struct((RUN,), jnp.float32),
    )
    call = lambda *a: K._estep_call(  # noqa: E731
        *a, n_barcodes=n_barcodes, doublets=True, interpret=True)
    with pytest.raises(ValueError, match="int32"):
        jax.eval_shape(call, *args)


@pytest.mark.parametrize("n_donors", [1, 3, 8])
@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_xla_expansion_is_exact(n_donors, doublet_prior):
    """The XLA path's elementwise expansion equals the f64 mixing product in f32."""
    rng = np.random.RandomState(n_donors)
    gp = rng.uniform(0.01, 0.99, (40, n_donors)).astype(np.float32)
    vid = rng.randint(0, 40, 300).astype(np.int32)
    mixing, _ = L.pseudogenotype_mixing([f"D{i}" for i in range(n_donors)], doublet_prior)
    got = np.asarray(L.expand_pseudogenotypes(jnp.asarray(gp), jnp.asarray(mixing), jnp.asarray(vid)))
    want = (gp[vid].astype(np.float64) @ mixing.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_donors", [2, 32])
def test_compiled_kernel_matches_xla(gpu, n_donors):
    """On the card: the compiled kernel against the exact XLA path."""
    rng = np.random.RandomState(1)
    n_barcodes, n_variants = 1000, 5000
    names = [f"D{i}" for i in range(n_donors)]
    gp = rng.uniform(0.01, 0.99, (n_variants, n_donors)).astype(np.float32)
    cb, vid, q = _calls(rng, "heavy", n_barcodes, n_variants, mean_calls=40)
    mixing, _ = L.pseudogenotype_mixing(names, 0.35)
    pen = L.doublet_penalties(n_donors, 0.35)
    runs = K.CallRuns.build(cb, vid, q, n_barcodes)
    got = np.asarray(K.estep_logits(
        jnp.asarray(gp), jnp.asarray(pen), jnp.asarray(runs.offsets),
        jnp.asarray(runs.vid), jnp.asarray(runs.q),
        n_barcodes=n_barcodes, doublets=K.check_mixing(mixing),
    ))
    want = np.asarray(L.barcode_logits(
        jnp.asarray(gp), jnp.asarray(mixing), jnp.asarray(pen),
        jnp.asarray(vid), jnp.asarray(cb), jnp.asarray(q), n_barcodes,
    ))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
