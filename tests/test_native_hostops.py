"""Native host-ops (radix argsort / hash join) vs their numpy definitions.

The numpy fallbacks inside native/hostops.py are the semantic ground truth;
the native paths must be bit-identical (stable order included). The native
library requirement mirrors test_native_scanner: skip without a toolchain,
hard-fail under DEMUX_NATIVE_REQUIRED=1 (CI).
"""
import os
import shutil

import numpy as np
import pytest

from demuxalot_tpu.native.hostops import match_keys, stable_argsort

gxx_available = shutil.which("g++") is not None or bool(os.environ.get("DEMUX_NATIVE_REQUIRED"))

if os.environ.get("DEMUX_NATIVE_REQUIRED"):
    from demuxalot_tpu.native import load_host_library

    load_host_library()  # raises at collection time if hostops cannot build


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
def test_host_library_actually_loads():
    """Guards against vacuous parity: with a toolchain present the native
    library must load, otherwise every test below would compare the numpy
    fallback against itself and stay green on a broken build."""
    import demuxalot_tpu.native.hostops as H

    assert H._host_lib() is not None


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
@pytest.mark.parametrize("seed", [0, 1])
def test_radix_argsort_matches_numpy_stable(seed):
    rng = np.random.RandomState(seed)
    # above the native threshold, with heavy duplicates to exercise stability
    n = 200_000
    for keys in (
        rng.randint(0, 50, n).astype(np.int64),  # tiny key space, long runs
        (rng.randint(0, 1 << 17, n).astype(np.int64) << 17) | rng.randint(0, 1 << 17, n),
        rng.randint(0, 2**48, n).astype(np.int64),  # wide keys, many passes
        np.zeros(n, dtype=np.int64),  # fully constant: zero passes
        np.arange(n, dtype=np.int64)[::-1].copy(),  # strictly decreasing
    ):
        got = stable_argsort(keys)
        want = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(got, want)


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
def test_radix_argsort_threaded_path_matches(seed=5):
    """Above ~2M keys the sort fans out across cores; stability and
    determinism must survive the per-block histogram + bucket-major scan
    (the 200k-key tests above run the single-thread path)."""
    rng = np.random.RandomState(seed)
    n = 3_000_000
    keys = (rng.randint(0, 1 << 17, n).astype(np.int64) << 17) | rng.randint(0, 1 << 17, n)
    got = stable_argsort(keys)
    np.testing.assert_array_equal(got, stable_argsort(keys))  # deterministic
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
def test_collapse_threaded_sort_matches(seed=6):
    """Collapse with the threaded sort engaged (2M+ rows), incl. duplicates."""
    from demuxalot_tpu.native.hostops import collapse_calls

    rng = np.random.RandomState(seed)
    n = 2_200_000
    vid = rng.randint(0, 40_000, n).astype(np.int32)
    cb = rng.randint(0, 20_000, n).astype(np.int32)
    snp = (vid // 2).astype(np.int32)
    p = rng.rand(n).astype(np.float32)
    out_vid, out_cb, out_snp, out_p, out_count = collapse_calls(vid, cb, snp, p)
    # reference: numpy stable sort + reduceat in the same member order
    key = vid.astype(np.int64) * 20_000 + cb
    order = np.argsort(key, kind="stable")
    sk = key[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    np.testing.assert_array_equal(out_vid, (sk[starts] // 20_000).astype(np.int32))
    np.testing.assert_array_equal(out_cb, (sk[starts] % 20_000).astype(np.int32))
    np.testing.assert_array_equal(out_snp, snp[order[starts]])
    np.testing.assert_array_equal(out_count, np.diff(np.append(starts, n)))
    np.testing.assert_array_equal(out_p, np.multiply.reduceat(p[order], starts).astype(np.float32))


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
def test_radix_argsort_small_and_int32():
    rng = np.random.RandomState(2)
    small = rng.randint(0, 1000, 500).astype(np.int32)  # below threshold: numpy path
    np.testing.assert_array_equal(
        stable_argsort(small), np.argsort(small, kind="stable")
    )
    big32 = rng.randint(0, 2**31 - 1, 100_000).astype(np.int32)
    np.testing.assert_array_equal(
        stable_argsort(big32), np.argsort(big32, kind="stable")
    )


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
def test_hash_match_matches_searchsorted_join(seed=3):
    rng = np.random.RandomState(seed)
    m, n = 4_096, 200_000
    table_keys = rng.choice(10 * m, m, replace=False).astype(np.int64)
    table_vals = rng.permutation(m).astype(np.int64)
    queries = rng.randint(0, 10 * m, n).astype(np.int64)

    got = match_keys(table_keys, table_vals, queries)

    order = np.argsort(table_keys, kind="stable")
    sorted_keys = table_keys[order]
    idx = np.searchsorted(sorted_keys, queries).clip(0, m - 1)
    want = np.where(sorted_keys[idx] == queries, table_vals[order][idx], -1)
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() and (got >= 0).any()  # both outcomes exercised


def _force_numpy_fallback(monkeypatch):
    """Make every hostops wrapper take its numpy path."""
    import demuxalot_tpu.native.hostops as H

    monkeypatch.setattr(H, "_lib", None)
    monkeypatch.setattr(H, "_lib_failed", True)


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
def test_collapse_calls_matches_numpy_path(monkeypatch):
    """Native fused collapse == the numpy sort+reduceat path, bit-exact."""
    from demuxalot_tpu.ops.packing import MoleculeCalls, molecule_calls_to_barcode_calls

    rng = np.random.RandomState(11)
    n = 200_000
    vid = rng.randint(0, 5_000, n).astype(np.int32)
    snp_of_vid = rng.randint(0, 2_500, 5_000).astype(np.int32)
    mc = MoleculeCalls(
        variant_id=vid,
        snp_id=snp_of_vid[vid],
        compressed_cb=rng.randint(0, 3_000, n).astype(np.int32),
        molecule_id=np.arange(n, dtype=np.int32),
        p_base_wrong=rng.rand(n).astype(np.float32),
        p_molecule_aligned_wrong=np.full(n, 0.01, np.float32),
    )
    native = molecule_calls_to_barcode_calls(mc)
    _force_numpy_fallback(monkeypatch)
    ref = molecule_calls_to_barcode_calls(mc)
    assert len(native) == len(ref)
    for field in ("variant_id", "snp_id", "compressed_cb",
                  "barcode_variant_count", "barcode_snp_count"):
        np.testing.assert_array_equal(native[field], ref[field])
    # stable member order => bit-identical float32 products
    np.testing.assert_array_equal(native["p_base_wrong"], ref["p_base_wrong"])


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
def test_match_compact_matches_numpy_join(monkeypatch):
    """Fused native calls->variants join == the numpy join, incl. drops."""
    from demuxalot_tpu.frontend.snp_counter import MOLECULE_DTYPE, SNP_CALL_DTYPE, CompressedSNPCalls
    from demuxalot_tpu.models.genotypes import ProbabilisticGenotypes
    from demuxalot_tpu.ops.packing import match_calls_to_variants

    rng = np.random.RandomState(13)
    n, n_mol, n_pos = 150_000, 50_000, 3_000
    genotypes = ProbabilisticGenotypes(["D1", "D2"])
    # register variants at even positions only -> ~half the calls unmatched
    for pos in range(0, n_pos, 2):
        genotypes.get_variant_id("chr1", pos, "A")
        genotypes.get_variant_id("chr1", pos, "C")
    genotypes._ensure_capacity(genotypes.n_variants)
    genotypes.variant_betas[: genotypes.n_variants] = 1.0

    molecules = np.zeros(n_mol, dtype=MOLECULE_DTYPE)
    molecules["compressed_cb"] = rng.randint(0, 500, n_mol)
    molecules["p_group_misaligned"] = rng.rand(n_mol).astype(np.float32)
    snp_calls = np.zeros(n, dtype=SNP_CALL_DTYPE)
    snp_calls["molecule_index"] = rng.randint(0, n_mol, n)
    snp_calls["snp_position"] = rng.randint(0, n_pos, n)
    snp_calls["base_index"] = rng.randint(0, 4, n)  # G/T never match
    snp_calls["p_base_wrong"] = rng.rand(n).astype(np.float32)
    calls = CompressedSNPCalls()
    calls.molecules = molecules
    calls.snp_calls = snp_calls
    calls._finalized = True

    native = match_calls_to_variants({"chr1": calls}, genotypes)
    _force_numpy_fallback(monkeypatch)
    ref = match_calls_to_variants({"chr1": calls}, genotypes)
    assert len(native) == len(ref) > 0
    for field in ("variant_id", "snp_id", "compressed_cb", "molecule_id"):
        np.testing.assert_array_equal(native[field], ref[field])
    for field in ("p_base_wrong", "p_molecule_aligned_wrong"):
        np.testing.assert_array_equal(native[field], ref[field])


def test_hash_match_empty_table():
    out = match_keys(
        np.empty(0, np.int64), np.empty(0, np.int64), np.arange(10, dtype=np.int64)
    )
    np.testing.assert_array_equal(out, np.full(10, -1))


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
@pytest.mark.parametrize("seed,n", [(21, 200_000), (22, 2_400_000)])
def test_collapse_keyed_matches_numpy_path(seed, n):
    """Native device-order collapse == its numpy definition, bit-exact.

    Covers both the single-thread and threaded (2M+) emit paths; the f32
    products must match because member order within a group is stable.
    """
    from demuxalot_tpu.native import hostops as H

    rng = np.random.RandomState(seed)
    n_variants = 40_000
    vid = rng.randint(0, n_variants, n).astype(np.int32)
    cb = rng.randint(0, 3_000, n).astype(np.int32)
    p = rng.rand(n).astype(np.float32)
    lut = rng.permutation(n_variants).astype(np.int32)
    cb_bits = 12
    native = H.collapse_calls_keyed(vid, cb, p, lut, cb_bits)
    saved_lib, saved_failed = H._lib, H._lib_failed
    H._lib, H._lib_failed = None, True
    try:
        ref = H.collapse_calls_keyed(vid, cb, p, lut, cb_bits)
    finally:
        H._lib, H._lib_failed = saved_lib, saved_failed
    for a, b, name in zip(native, ref, ("vid", "cb", "p", "count")):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the output really is the M-step stream order: vid non-decreasing
    assert (np.diff(native[0].astype(np.int64)) >= 0).all()


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
@pytest.mark.parametrize("seed,n", [(31, 200_000), (32, 2_400_000)])
def test_sort_calls_by_cb_matches_numpy_path(seed, n):
    from demuxalot_tpu.native import hostops as H

    rng = np.random.RandomState(seed)
    cb = rng.randint(0, 50_000, n).astype(np.int32)
    vid = rng.randint(0, 1 << 30, n).astype(np.int32)
    q = rng.rand(n).astype(np.float32)
    native = H.sort_calls_by_cb(cb, vid, q)
    order = np.argsort(cb, kind="stable")
    np.testing.assert_array_equal(native[0], cb[order])
    np.testing.assert_array_equal(native[1], vid[order])
    np.testing.assert_array_equal(native[2], q[order])


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
def test_collapse_device_order_matches_legacy_collapse(monkeypatch):
    """SoA device-order collapse == legacy registry-order collapse, re-sorted.

    Same groups, same stable member products — only the row order differs
    (device vid vs registry vid). Verified by mapping the legacy recarray
    into device order and comparing all columns.
    """
    from demuxalot_tpu.ops.packing import (
        MoleculeCalls, VariantReindex, collapse_device_order,
        molecule_calls_to_barcode_calls,
    )

    rng = np.random.RandomState(41)
    n, n_variants = 150_000, 9_000
    # non-trivial reindex: variant->snp NOT already sorted
    variant2snp = rng.permutation(np.repeat(np.arange(n_variants // 2), 2)).astype(np.int64)
    reindex = VariantReindex.build(variant2snp)
    vid = rng.randint(0, n_variants, n).astype(np.int32)
    mc = MoleculeCalls(
        variant_id=vid,
        snp_id=variant2snp[vid].astype(np.int32),
        compressed_cb=rng.randint(0, 2_000, n).astype(np.int32),
        molecule_id=np.arange(n, dtype=np.int32),
        p_base_wrong=rng.rand(n).astype(np.float32),
        p_molecule_aligned_wrong=np.full(n, 0.01, np.float32),
    )
    soa = collapse_device_order(mc, reindex)
    legacy = molecule_calls_to_barcode_calls(mc)
    dev_vid = reindex.inverse[legacy["variant_id"].astype(np.int64)]
    order = np.lexsort((legacy["compressed_cb"], dev_vid))
    np.testing.assert_array_equal(soa.vid, dev_vid[order])
    np.testing.assert_array_equal(soa.cb, legacy["compressed_cb"][order])
    np.testing.assert_array_equal(soa.q, legacy["p_base_wrong"][order])
    np.testing.assert_array_equal(soa.count, legacy["barcode_variant_count"][order])


@pytest.mark.parametrize("change", ["none", "source", "flags"])
def test_native_library_path_is_keyed(tmp_path, change):
    """The library file name changes with the source and the compile flags."""
    from demuxalot_tpu import native

    src = tmp_path / "keyed.cpp"
    src.write_text('extern "C" int answer() { return 1; }\n')
    base = native.library_path(src, extra=("-pthread",))
    if change == "source":
        src.write_text('extern "C" int answer() { return 2; }\n')
    extra = ("-pthread", "-DOTHER") if change == "flags" else ("-pthread",)
    other = native.library_path(src, extra=extra)
    assert (other == base) == (change == "none")
    assert base.parent == native.BUILD_DIR
    assert "-march=native" not in native.compile_command(src, "out", extra)


@pytest.mark.skipif(not gxx_available, reason="no C++ toolchain")
def test_build_library_rebuilds_only_on_change(tmp_path, monkeypatch):
    """A built library is reused as is; an edited source gets a new one."""
    import ctypes

    from demuxalot_tpu import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "keyed.cpp"
    src.write_text('extern "C" int answer() { return 7; }\n')
    lib = native.build_library(src)
    stamp = lib.stat().st_mtime_ns
    assert native.build_library(src) == lib
    assert lib.stat().st_mtime_ns == stamp
    assert ctypes.CDLL(str(lib)).answer() == 7
    src.write_text('extern "C" int answer() { return 8; }\n')
    rebuilt = native.build_library(src)
    assert rebuilt != lib
    assert ctypes.CDLL(str(rebuilt)).answer() == 8
