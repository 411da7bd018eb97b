"""Build and load the port's native host library.

The BAM and FASTQ readers, the k-mer enumeration and radix sort, the
bucket-table placement and its passes over the placed keys, the oct-row
pads, the row gather and the alignment-mode grouping run on the host in
C++: `csrc/bamreader.cpp`, `csrc/fastqreader.cpp`, `csrc/kmersort.cpp`
and `csrc/alnweights.cpp`, the port's own copies of the JAX package's
sources. `csrc/eqtable.cpp`, the port's own, is the eq accumulator's
hash table of classes (`inference/eqclasses.py`). At first use g++
compiles the five into one library,
`_build/libsalmonhost-<hash>.so` (OpenMP, zlib), where the hash covers
the sources and the flags, so an edited source is rebuilt and a built
one is reused. The library is host
code: the entry points take it on the card's machine and on the CPU
alike, and a failed compile raises with the compiler's log. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
SOURCES = ("bamreader.cpp", "fastqreader.cpp", "kmersort.cpp",
           "alnweights.cpp", "eqtable.cpp")
CXX_FLAGS = ["-O3", "-std=c++17", "-fopenmp", "-shared", "-fPIC"]
LIBS = ["-lz"]

_loaded: dict = {}


def _arr(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


_H, _S = ctypes.c_void_p, ctypes.c_char_p
_I32, _I64, _U64, _F64 = (ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64,
                          ctypes.c_double)
_i32p, _i64p, _u8p, _u16p = (_arr(np.int32), _arr(np.int64), _arr(np.uint8),
                             _arr(np.uint16))
_u32p, _u64p, _f32p, _f64p = (_arr(np.uint32), _arr(np.uint64),
                              _arr(np.float32), _arr(np.float64))

# name: (restype, argtypes) of every C entry the port calls
SIGNATURES = {
    # csrc/bamreader.cpp
    "bam_open": (_H, [_S]),
    "bam_close": (None, [_H]),
    "bam_n_refs": (_I32, [_H]),
    "bam_ref_name": (_S, [_H, _I32]),
    "bam_ref_len": (_I32, [_H, _I32]),
    "bam_text_header": (_S, [_H]),
    "bam_next_batch": (_I64, [
        _H, _I64, _I64, _I64, _i32p, _i32p, _u16p, _u8p, _i32p, _i32p,
        _i32p, _i32p, _i64p, _i64p, _i32p, _i32p, _i32p, _f32p, _u64p,
        _u8p, _u8p, _u32p, _u8p, _I64]),
    "bam_pad_batch": (None, [
        _I64, _i64p, _i32p, _i64p, _u8p, _i64p, _i32p, _u8p, _u32p, _I32,
        _I32, _I32, _i32p, _i32p, _u8p, _u8p]),
    # csrc/fastqreader.cpp
    "fastq_open": (_H, [_S]),
    "fastq_close": (None, [_H]),
    "fastq_next_batch": (_I64, [_H, _I64, _I64, _u8p, _i32p, _u8p, _I64]),
    # csrc/alnweights.cpp
    "aln_frag_starts": (_I64, [_i64p, _I64, _i64p]),
    "aln_group_eq": (_I64, [
        _i64p, _I64, _I64, _i32p, _i64p, _i64p, _f64p, _F64, _I64, _I32,
        _I64, _i32p, _f32p, _f64p, _i64p, _f64p]),
    # csrc/kmersort.cpp
    "kmer_count": (_I64, [_u8p, _i64p, _I64, _I32, _i64p]),
    "kmer_enumerate": (None, [_u8p, _i64p, _I64, _I32, _i64p, _u64p,
                              _u64p]),
    "kmer_count_part": (_I64, [_u8p, _i64p, _I64, _I32, _i64p, _I32, _U64]),
    "kmer_enumerate_part": (None, [_u8p, _i64p, _I64, _I32, _i64p, _u64p,
                                   _u64p, _I32, _U64]),
    "radix_sort_u64": (None, [_u64p, _u64p, _I64, _I32, _u64p, _u64p]),
    "kmer_decode_payload": (None, [_u64p, _I64, _i32p, _i32p, _u8p]),
    "kmer_decode_payload_pf": (None, [_u64p, _I64, _i32p, _i32p]),
    "oct_align_pads": (None, [_i64p, _I64, _I64, _i64p]),
    "table_place": (_I64, [_u64p, _u32p, _I64, _I64, _i32p]),
    "gather_rows": (None, [_u8p, _i64p, _I64, _I64, _u8p]),
    "table_slot_ranks": (None, [_i32p, _I64, _i64p]),
    "table_first_match": (None, [_i32p, _i32p, _i64p, _i64p, _u32p, _I64,
                                 _i64p, _i64p]),
    "table_fill_rows": (None, [_i32p, _I64, _i32p, _i32p, _i32p]),
    "table_inline": (_I64, [_i32p, _I64, _i64p, _i64p, _i32p, _i32p, _i32p,
                            _I64, _u32p, _i32p]),
    # csrc/eqtable.cpp
    "eqt_new": (_H, [_I64, _I64, _I64]),
    "eqt_free": (None, [_H]),
    "eqt_size": (_I64, [_H]),
    "eqt_merge": (_I64, [_H, _i32p, _f64p, _f64p, _I64]),
    "eqt_export": (_I64, [_H, _i32p, _f64p, _f64p]),
    "eqt_dedupe": (_I64, [_i32p, _f32p, _I64, _I64, _I64, _i32p, _f64p,
                          _f64p]),
}


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host library of "
                           "salmon_tpu_torch needs a C++ compiler")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD, f"libsalmonhost-{h.hexdigest()[:16]}.so")


def build():
    """Compile the library unless it is built. Returns (seconds, compiler
    log) of the compile, or None when it was built already; a failed
    compile raises with its log."""
    out = library_path()
    if os.path.exists(out):
        return None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_cxx(), *CXX_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES), *LIBS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on the host library "
                           f"({' '.join(SOURCES)}):\n{proc.stdout}")
    # several processes may build at once: each writes its own file and
    # the last rename wins with an identical library
    os.replace(tmp, out)
    return time.perf_counter() - t0, proc.stdout


def lib() -> ctypes.CDLL:
    """The loaded host library with its signatures, built first if
    needed."""
    out = _loaded.get("lib")
    if out is None:
        build()
        out = ctypes.CDLL(library_path())
        for name, (res, args) in SIGNATURES.items():
            fn = getattr(out, name)
            fn.restype, fn.argtypes = res, args
        _loaded["lib"] = out
    return out
