"""Native runtime loader: compiles router.cpp once (g++ -O3 -shared) into a
cache directory and binds it with ctypes. Falls back to None when no
compiler is available — callers keep a numpy path.

The reference ships its host runtime as C++ (libadapm.a); here the host-side
hot loops (route resolution per fused step, stat counters, intent/replica
scans) are the native surface, while the device data plane is torch and hand-written CUDA kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_SRC = os.path.join(os.path.dirname(__file__), "router.cpp")


def _cache_dir() -> str:
    d = os.environ.get("ADAPM_TORCH_NATIVE_CACHE") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "build", "native")
    os.makedirs(d, exist_ok=True)
    return d


def _host_tag() -> str:
    """Cache-key component for the build host's ISA: -march=native output is
    only valid on CPUs with the same feature set (shared cache dirs on NFS
    homes would otherwise serve SIGILL-ing binaries to older machines)."""
    import platform
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    parts.append(line.split(":", 1)[1].strip())
                    break
    except OSError:
        pass
    return hashlib.sha256(" ".join(parts).encode()).hexdigest()[:8]


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_cache_dir(),
                       f"libadapm_router_{tag}_{_host_tag()}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        try:  # -march=native can be unsupported in exotic environments
            cmd.remove("-march=native")
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    os.replace(tmp, out)  # atomic vs concurrent builds
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled router library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("ADAPM_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            # apm-lint: disable=APM008 the host-side C++ router
            # (native/router.cpp): a CPU library with no device code, not
            # a kernel library
            lib = ctypes.CDLL(path)
        except OSError:
            # stale/incompatible cached binary: fall back to numpy
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.adapm_route.restype = ctypes.c_int64
        lib.adapm_route.argtypes = [
            i64p, ctypes.c_int64, ctypes.c_int64, i32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p,
            i32p, i32p, u8p, u8p]
        lib.adapm_count.restype = ctypes.c_int64
        lib.adapm_count.argtypes = [i64p, u8p, ctypes.c_int64,
                                    ctypes.c_int64, i64p, i64p]
        lib.adapm_intent_max.restype = ctypes.c_int64
        lib.adapm_intent_max.argtypes = [i64p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64,
                                         i32p]
        lib.adapm_replica_scan.restype = ctypes.c_int64
        lib.adapm_replica_scan.argtypes = [
            i64p, i32p, ctypes.c_int64, i32p, i64p, ctypes.c_int64, u8p]
        lib.adapm_replica_scan2.restype = None
        lib.adapm_replica_scan2.argtypes = [
            i64p, i32p, ctypes.c_int64, i32p, i64p, ctypes.c_int64, u8p,
            i64p, i64p, i64p, i64p, i64p]
        _lib = lib
        return _lib


def route(lib, keys: np.ndarray, owner: np.ndarray, slot: np.ndarray,
          cache_slot_row: np.ndarray, shard: int, oob: int,
          write_through: bool):
    """ctypes wrapper for adapm_route; returns Server._route's tuple layout
    plus the per-key local mask (for locality stats)."""
    n = len(keys)
    num_keys = len(owner)
    o_sh = np.empty(n, np.int32)
    o_sl = np.empty(n, np.int32)
    c_sh = np.empty(n, np.int32)
    c_sl = np.empty(n, np.int32)
    use_c = np.empty(n, np.uint8)
    local = np.empty(n, np.uint8)
    keys = np.ascontiguousarray(keys, np.int64)
    n_remote = lib.adapm_route(
        keys, n, num_keys, owner, slot, cache_slot_row, shard, oob,
        int(write_through), o_sh, o_sl, c_sh, c_sl, use_c, local)
    if n_remote < 0:
        bad = keys[-(n_remote + 1)]
        raise IndexError(
            f"key {bad} is outside the key range [0, {num_keys})")
    return o_sh, o_sl, c_sh, c_sl, use_c.astype(bool), int(n_remote), local


def replica_scan_partition(lib, keys: np.ndarray, shards: np.ndarray,
                           intent_end: np.ndarray, min_clock: np.ndarray,
                           num_keys: int, cross):
    """ctypes wrapper for adapm_replica_scan2: partition a channel
    snapshot into (keep_local, keep_cross, drop_local, drop_cross)
    index arrays in one native pass. `cross` is a uint8 owner-is-remote
    mask or None (single process)."""
    n = len(keys)
    keys = np.ascontiguousarray(keys, np.int64)
    shards = np.ascontiguousarray(shards, np.int32)
    cross = np.zeros(n, np.uint8) if cross is None \
        else np.ascontiguousarray(cross, np.uint8)
    keep_l = np.empty(n, np.int64)
    keep_x = np.empty(n, np.int64)
    drop_l = np.empty(n, np.int64)
    drop_x = np.empty(n, np.int64)
    counts = np.zeros(4, np.int64)
    lib.adapm_replica_scan2(
        keys, shards, n, np.ascontiguousarray(intent_end.ravel(), np.int32),
        min_clock, num_keys, cross, keep_l, keep_x, drop_l, drop_x, counts)
    return (keep_l[: counts[0]], keep_x[: counts[1]],
            drop_l[: counts[2]], drop_x[: counts[3]])
