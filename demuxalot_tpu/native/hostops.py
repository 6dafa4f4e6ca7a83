"""Python wrappers for the C++ host-ops library (sort/join primitives).

Product-scale packing and kernel-layout builds are dominated by numpy's
stable argsort (~1.7 s at 9.2M int64 keys on this host) and searchsorted
(~1.4 s for 9.2M probes); the native routines run the same contracts
~10x faster (see hostops.cpp). Every wrapper falls back to the numpy
implementation when the toolchain is unavailable, and the numpy path
remains the semantic definition — parity is pinned by
tests/test_native_hostops.py.
"""
from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_lib_failed = False


def _host_lib():
    global _lib, _lib_failed
    if _lib is None and not _lib_failed:
        try:
            from . import load_host_library

            _lib = load_host_library()
        except Exception:
            _lib_failed = True
    return _lib


def _sliced(g: int, n: int, *arrays):
    """First-g-rows views of over-allocated outputs.

    Copies (freeing the tail) only when most rows were dropped; otherwise a
    view avoids a second multi-hundred-MB allocation + copy at product scale.
    """
    if g < n * 3 // 4:
        return tuple(a[:g].copy() for a in arrays)
    return tuple(a[:g] for a in arrays)


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable ascending argsort for integer keys; returns int64 order.

    Exact drop-in for ``np.argsort(keys, kind="stable")`` on integer
    arrays (the native radix path requires non-negative keys; negatives
    fall back to numpy).
    """
    keys = np.ascontiguousarray(keys)
    n = len(keys)
    lib = _host_lib()
    if (
        lib is None
        or n < 65_536  # numpy wins below ~64k (native call setup + copies)
        or not np.issubdtype(keys.dtype, np.integer)
        or (n and int(keys.min()) < 0)
    ):
        return np.argsort(keys, kind="stable")
    keys64 = np.ascontiguousarray(keys, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    lib.demux_radix_argsort_i64(
        keys64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return order


def match_compact(table_keys, table_vids, calls_rec, molecules_rec):
    """Fused join of calls against a chromosome's variant registry.

    Reads the call/molecule fields straight out of the packed numpy record
    buffers (no per-field strided extraction, which re-reads the whole
    record buffer per field — ~3.4 s at 22M calls). Returns
    (vid, cb, mol_index, p_wrong, p_mol) for the matched calls, in call
    order — or None to request the numpy path. Table keys must be the
    unique non-negative ``pos*6 + base_code`` registry keys; ``calls_rec``
    / ``molecules_rec`` must be contiguous structured arrays carrying the
    SNP_CALL_DTYPE / MOLECULE_DTYPE fields.
    """
    lib = _host_lib()
    n = len(calls_rec)
    m = len(table_keys)
    if (
        lib is None or n < 65_536 or m == 0
        or not calls_rec.flags.c_contiguous
        or not molecules_rec.flags.c_contiguous
    ):
        return None
    table_keys = np.ascontiguousarray(table_keys, dtype=np.int64)
    if int(table_keys.min()) < 0:
        return None
    table_vids = np.ascontiguousarray(table_vids, dtype=np.int64)
    cf = calls_rec.dtype.fields
    mf = molecules_rec.dtype.fields
    # the C++ hard-codes 4-byte i32/f32 and 1-byte u8 reads at these field
    # offsets; a drifted field dtype must route to the numpy path instead
    # of silently misreading memory
    expected = (
        (cf, "snp_position", np.int32), (cf, "base_index", np.uint8),
        (cf, "p_base_wrong", np.float32), (cf, "molecule_index", np.int32),
        (mf, "compressed_cb", np.int32), (mf, "p_group_misaligned", np.float32),
    )
    if any(fields[name][0] != np.dtype(dt) for fields, name, dt in expected):
        return None
    out_vid = np.empty(n, np.int32)
    out_cb = np.empty(n, np.int32)
    out_mol = np.empty(n, np.int32)
    out_p = np.empty(n, np.float32)
    out_pmol = np.empty(n, np.float32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    cp = ctypes.c_char_p
    k = lib.demux_match_compact_strided(
        table_keys.ctypes.data_as(i64p), table_vids.ctypes.data_as(i64p), m,
        ctypes.cast(calls_rec.ctypes.data, cp), calls_rec.dtype.itemsize,
        cf["snp_position"][1], cf["base_index"][1],
        cf["p_base_wrong"][1], cf["molecule_index"][1],
        ctypes.cast(molecules_rec.ctypes.data, cp), molecules_rec.dtype.itemsize,
        mf["compressed_cb"][1], mf["p_group_misaligned"][1],
        len(molecules_rec), n,
        out_vid.ctypes.data_as(i32p), out_cb.ctypes.data_as(i32p),
        out_mol.ctypes.data_as(i32p), out_p.ctypes.data_as(f32p),
        out_pmol.ctypes.data_as(f32p),
    )
    if k < 0:
        # the C++ found a molecule_index outside the molecules table —
        # same caller bug the numpy path surfaces as an IndexError
        raise IndexError(
            "molecule_index out of range for the molecules table "
            f"(n_molecules={len(molecules_rec)})"
        )
    return _sliced(k, n, out_vid, out_cb, out_mol, out_p, out_pmol)


def collapse_calls(vid: np.ndarray, cb: np.ndarray, snp: np.ndarray,
                   p: np.ndarray):
    """Group calls by (vid, cb): per group vid/cb/snp, f32 product of p in
    stable member order, and member count — or None to request the numpy
    path. All inputs int32/float32, vid/cb non-negative.
    """
    lib = _host_lib()
    n = len(vid)
    if lib is None or n < 65_536:
        return None
    vid = np.ascontiguousarray(vid, dtype=np.int32)
    cb = np.ascontiguousarray(cb, dtype=np.int32)
    if int(vid.min()) < 0 or int(cb.min()) < 0:
        return None  # negative ids (e.g. unmatched sentinels): numpy path
    snp = np.ascontiguousarray(snp, dtype=np.int32)
    p = np.ascontiguousarray(p, dtype=np.float32)
    out_vid = np.empty(n, np.int32)
    out_cb = np.empty(n, np.int32)
    out_snp = np.empty(n, np.int32)
    out_p = np.empty(n, np.float32)
    out_count = np.empty(n, np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    g = lib.demux_collapse_calls(
        vid.ctypes.data_as(i32p), cb.ctypes.data_as(i32p),
        snp.ctypes.data_as(i32p), p.ctypes.data_as(f32p), n,
        out_vid.ctypes.data_as(i32p), out_cb.ctypes.data_as(i32p),
        out_snp.ctypes.data_as(i32p), out_p.ctypes.data_as(f32p),
        out_count.ctypes.data_as(i64p),
    )
    return _sliced(g, n, out_vid, out_cb, out_snp, out_p, out_count)


def collapse_calls_keyed(vid: np.ndarray, cb: np.ndarray, p: np.ndarray,
                         lut: np.ndarray, cb_bits: int):
    """Device-order collapse: group calls by (lut[vid], cb).

    Returns ``(device_vid, cb, p_product, count)`` with rows sorted by
    (device_vid, cb); ``p_product`` is the float32 product over each
    group's members in stable input order. ``lut`` is the variant
    renumbering (``VariantReindex.inverse``); ``cb`` must fit in
    ``cb_bits`` bits. Falls back to numpy (the semantic definition) when
    the native library is unavailable or inputs are small/negative.
    """
    vid = np.ascontiguousarray(vid, dtype=np.int32)
    cb = np.ascontiguousarray(cb, dtype=np.int32)
    p = np.ascontiguousarray(p, dtype=np.float32)
    lut = np.ascontiguousarray(lut, dtype=np.int32)
    n = len(vid)
    lib = _host_lib()
    native_ok = (
        lib is not None and n >= 65_536
        and (n == 0 or (int(vid.min()) >= 0 and int(cb.min()) >= 0))
        and (len(lut) == 0 or int(lut.min()) >= 0)
        # the C++ reads lut[vid] unchecked; a caller sizing bug must hit
        # the numpy path's IndexError, not corrupt memory
        and (n == 0 or int(vid.max()) < len(lut))
    )
    if native_ok:
        out_vid = np.empty(n, np.int32)
        out_cb = np.empty(n, np.int32)
        out_p = np.empty(n, np.float32)
        out_count = np.empty(n, np.int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        g = lib.demux_collapse_calls_keyed(
            vid.ctypes.data_as(i32p), cb.ctypes.data_as(i32p),
            p.ctypes.data_as(f32p), n,
            lut.ctypes.data_as(i32p), int(cb_bits),
            out_vid.ctypes.data_as(i32p), out_cb.ctypes.data_as(i32p),
            out_p.ctypes.data_as(f32p), out_count.ctypes.data_as(i64p),
        )
        return _sliced(g, n, out_vid, out_cb, out_p, out_count)
    # numpy path — the semantic definition the native op must match bit-wise
    if n == 0:
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty(0, np.float32), np.empty(0, np.int64))
    dev_vid = lut[vid].astype(np.int64)
    key = (dev_vid << int(cb_bits)) | cb.astype(np.int64)
    order = np.argsort(key, kind="stable")
    sorted_keys = key[order]
    starts = np.flatnonzero(
        np.concatenate(([True], sorted_keys[1:] != sorted_keys[:-1]))
    )
    counts = np.diff(np.append(starts, n)).astype(np.int64)
    products = np.multiply.reduceat(p[order], starts).astype(np.float32)
    unique_keys = sorted_keys[starts]
    out_vid = (unique_keys >> int(cb_bits)).astype(np.int32)
    out_cb = (unique_keys & ((1 << int(cb_bits)) - 1)).astype(np.int32)
    return out_vid, out_cb, products, counts


def sort_calls_by_cb(cb: np.ndarray, vid: np.ndarray, q: np.ndarray):
    """Stable sort of the (cb, vid, q) call columns by cb.

    Returns new contiguous ``(cb_sorted, vid_sorted, q_sorted)`` arrays.
    Numpy path (argsort + gathers) is the semantic definition.
    """
    cb = np.ascontiguousarray(cb, dtype=np.int32)
    vid = np.ascontiguousarray(vid, dtype=np.int32)
    q = np.ascontiguousarray(q, dtype=np.float32)
    n = len(cb)
    lib = _host_lib()
    if lib is not None and n >= 65_536 and int(cb.min()) >= 0:
        out_cb = np.empty(n, np.int32)
        out_vid = np.empty(n, np.int32)
        out_q = np.empty(n, np.float32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.demux_sort_calls_by_cb(
            cb.ctypes.data_as(i32p), vid.ctypes.data_as(i32p),
            q.ctypes.data_as(f32p), n,
            out_cb.ctypes.data_as(i32p), out_vid.ctypes.data_as(i32p),
            out_q.ctypes.data_as(f32p),
        )
        return out_cb, out_vid, out_q
    order = np.argsort(cb, kind="stable")
    return cb[order], vid[order], q[order]


def group_sum_broadcast(keys: np.ndarray, weights: np.ndarray):
    """out[i] = sum of weights over rows sharing keys[i]; None = numpy path.

    Keys int64 non-negative; weights float64; f64 accumulation order is the
    stable sorted-member order (matches the numpy reduceat path).
    """
    lib = _host_lib()
    n = len(keys)
    if lib is None or n < 65_536:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if int(keys.min()) < 0:
        return None  # negative keys: numpy path
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    out = np.empty(n, np.float64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.demux_group_sum_broadcast(
        keys.ctypes.data_as(i64p), weights.ctypes.data_as(f64p), n,
        out.ctypes.data_as(f64p),
    )
    return out


def match_keys(table_keys: np.ndarray, table_vals: np.ndarray,
               queries: np.ndarray) -> np.ndarray:
    """For each query key: the matching table value, or -1 when absent.

    Semantics of the sorted-join idiom
    ``idx = searchsorted(table, q).clip(0, m-1); where(table[idx] == q, vals[idx], -1)``
    with unique non-negative table keys, via an L2-resident hash table.
    """
    table_keys = np.ascontiguousarray(table_keys, dtype=np.int64)
    table_vals = np.ascontiguousarray(table_vals, dtype=np.int64)
    queries = np.ascontiguousarray(queries, dtype=np.int64)
    m, n = len(table_keys), len(queries)
    lib = _host_lib()
    if lib is None or m == 0 or n < 65_536 or (m and int(table_keys.min()) < 0):
        if m == 0:
            return np.full(n, -1, dtype=np.int64)
        order = np.argsort(table_keys, kind="stable")
        sorted_keys = table_keys[order]
        idx = np.searchsorted(sorted_keys, queries).clip(0, m - 1)
        return np.where(
            sorted_keys[idx] == queries, table_vals[order][idx], -1
        ).astype(np.int64)
    out = np.empty(n, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.demux_hash_match_i64(
        table_keys.ctypes.data_as(i64p), table_vals.ctypes.data_as(i64p), m,
        queries.ctypes.data_as(i64p), n, out.ctypes.data_as(i64p),
    )
    return out
