"""Native (C++) components: built on first use with the system toolchain.

Each library is compiled from its tracked source into ``_build/`` (next to
this file, git-ignored) under a file name keyed on a hash of the source and
the compile command, so a copied tree never loads a library built from other
sources or with other flags. The command targets the generic x86-64 ISA (no
``-march=native``), so a library built on one host also runs on another.
Absence of a working toolchain degrades gracefully — callers fall back to
the pure-Python paths — but the loaders below raise, so callers that need
the native path can insist on it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "_build"
_SCAN_SRC = _DIR / "scanner.cpp"
_HOST_SRC = _DIR / "hostops.cpp"

_lib_handle = None
_host_handle = None


def compile_command(src: Path, out: str, extra=()) -> list:
    return ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(src), *extra, "-o", out]


def library_path(src: Path, extra=()) -> Path:
    """Where the library for ``src`` built with ``extra`` flags lives."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update("\0".join(compile_command(Path(src.name), "OUT", extra)).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_library(src: Path, extra=()) -> Path:
    """Compile ``src`` unless its keyed library exists; return the path."""
    lib = library_path(src, extra)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"  # unique per process: parallel workers may race
        subprocess.run(compile_command(src, tmp, extra), check=True, capture_output=True)
        Path(tmp).replace(lib)  # atomic on POSIX
    return lib


def load_host_library() -> ctypes.CDLL:
    """Compile (if needed) and load the host-ops library (sort/join)."""
    global _host_handle
    if _host_handle is not None:
        return _host_handle
    lib = ctypes.CDLL(str(build_library(_HOST_SRC, extra=("-pthread",))))
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.demux_radix_argsort_i64.restype = None
    lib.demux_radix_argsort_i64.argtypes = [i64p, ctypes.c_int64, i64p]
    lib.demux_hash_match_i64.restype = None
    lib.demux_hash_match_i64.argtypes = [
        i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int64, i64p,
    ]
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.demux_match_compact_strided.restype = ctypes.c_int64
    lib.demux_match_compact_strided.argtypes = [
        i64p, i64p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, i32p, f32p, f32p,
    ]
    lib.demux_collapse_calls.restype = ctypes.c_int64
    lib.demux_collapse_calls.argtypes = [
        i32p, i32p, i32p, f32p, ctypes.c_int64,
        i32p, i32p, i32p, f32p, i64p,
    ]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.demux_group_sum_broadcast.restype = None
    lib.demux_group_sum_broadcast.argtypes = [i64p, f64p, ctypes.c_int64, f64p]
    lib.demux_collapse_calls_keyed.restype = ctypes.c_int64
    lib.demux_collapse_calls_keyed.argtypes = [
        i32p, i32p, f32p, ctypes.c_int64, i32p, ctypes.c_int32,
        i32p, i32p, f32p, i64p,
    ]
    lib.demux_sort_calls_by_cb.restype = None
    lib.demux_sort_calls_by_cb.argtypes = [
        i32p, i32p, f32p, ctypes.c_int64, i32p, i32p, f32p,
    ]
    _host_handle = lib
    return lib


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the native scanner library."""
    global _lib_handle
    if _lib_handle is not None:
        return _lib_handle
    lib = ctypes.CDLL(str(build_library(_SCAN_SRC, extra=("-lz",))))

    lib.scan_region.restype = ctypes.c_void_p
    lib.scan_region.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ]
    lib.scan_n_molecules.restype = ctypes.c_int64
    lib.scan_n_molecules.argtypes = [ctypes.c_void_p]
    lib.scan_n_calls.restype = ctypes.c_int64
    lib.scan_n_calls.argtypes = [ctypes.c_void_p]
    lib.scan_fill.restype = None
    lib.scan_fill.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
    ]
    lib.scan_free.restype = None
    lib.scan_free.argtypes = [ctypes.c_void_p]

    lib.count_coverage.restype = ctypes.c_int
    lib.count_coverage.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
    ]

    _lib_handle = lib
    return lib
