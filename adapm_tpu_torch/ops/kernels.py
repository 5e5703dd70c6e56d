"""The hand-written CUDA kernels of the port, each beside its plain
PyTorch version.

    K1 routed_gather        csrc/routed_gather.cu   (TPU: pallas_kernels.gather_rows)
    K2 adagrad_update /     csrc/adagrad.cu         (TPU: pallas_kernels.adagrad_apply)
       adagrad_apply
    K3 ordered_scatter_add  csrc/ordered_scatter.cu (XLA: jaxport._scatter_add)
    K4 pool_eval_counts     csrc/pool_eval_counts.cu (XLA: models/kge.py
                                                     make_pool_eval_counts)
    K5 complex_step         csrc/complex_step.cu    (XLA: ComplEx model math
                                                     of ops/fused.py
                                                     _build_device_routed_body;
                                                     K2's arithmetic as its
                                                     epilogue)
    K6 sgns_step            csrc/sgns_step.cu       (XLA: the same body with
                                                     models/sgns.py sgns_loss)
    K7 mf_step              csrc/mf_step.cu         (XLA: the same body with
                                                     models/mf.py make_mf_loss)
    K8 gather_pool          csrc/gather_pool.cu     (XLA: jaxport._gather_pool,
                                                     the serving plane's fused
                                                     embedding-bag read)
    K9 gather_cold          csrc/gather_cold.cu     (XLA: jaxport._gather_cold,
                                                     _gather_cold_fp16/_int8:
                                                     a tiered store's read)
    K10 gather_pool_cold    csrc/gather_pool.cu     (XLA: jaxport.
                                                     _gather_pool_cold*: K8
                                                     with cold members)
    K11 write_main_rows     csrc/write_main_rows.cu (XLA: jaxport.
                                                     _write_main_rows*: the
                                                     promotion upload)
    K12 sync_compress       csrc/sync_compress.cu   (XLA: the wire transform
                                                     of jaxport.
                                                     _sync_replicas_compressed)
    K13 alltoall_put        csrc/alltoall_put.cu    (XLA: the all-to-all of
                                                     parallel/collective.py,
                                                     jaxport.compile_collective:
                                                     the BSP exchange, HBM to
                                                     HBM through CUDA IPC)
    K14 drop_set /          csrc/drop_set.cu        (XLA: jaxport's masked
        drop_set_install /                           set/copy programs,
        drop_set_zero                                _set_rows ... _clear_rows,
                                                     _install_cache_rows*)
    K15 sync_round          csrc/sync_round.cu      (XLA: jaxport._sync_replicas
                                                     and _sync_replicas_
                                                     thresholded: claim, fold
                                                     and install, no sort)
    K16 rescal_step         csrc/rescal_step.cu     (XLA: RESCAL model math of
                                                     ops/fused.py
                                                     _build_device_routed_body;
                                                     K2's arithmetic as its
                                                     epilogue)

K9-K12 read and write the wire formats of tier/quant.py (fp32, fp16,
int8 with a per-row f32 scale) bit for bit as its host twins do
(csrc/quant.cuh).

K1 and K3 also take an ordered list of coordinate segments, one per
role of a pool class (`routed_gather_segments`,
`ordered_scatter_add_segments`): one launch folds them as one batch in
list order, so the fused step launches each once per class per step.
K3 splits into its ordering pass (`ordered_scatter_order`: flat targets
and a stable sort) and its fold (`ordered_scatter_fold`).

Every wrapper takes CUDA tensors to its kernel and CPU tensors to its
plain version; there is no fallback between the two. A wrapper checks
device, dtype, shape and contiguity, launches on the current stream,
adds one to `LAUNCHES[name]` per launch, and raises if the launch
failed; the launches of a replayed CUDA graph count apart, in
`REPLAYED`. The kernels are compiled at first use with `nvcc` for sm_90a
(one process per source, all started together) into shared libraries
with a plain C interface under `build/kernels/`, and loaded with ctypes;
a library's name carries a hash of its source and of the shared headers
(`csrc/*.cuh`). `build()` compiles them up front and returns the seconds
it took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SOURCES = {"routed_gather": "routed_gather.cu",
            "adagrad": "adagrad.cu",
            "ordered_scatter": "ordered_scatter.cu",
            "pool_eval_counts": "pool_eval_counts.cu",
            "complex_step": "complex_step.cu",
            "sgns_step": "sgns_step.cu",
            "mf_step": "mf_step.cu",
            "gather_pool": "gather_pool.cu",
            "gather_cold": "gather_cold.cu",
            "write_main_rows": "write_main_rows.cu",
            "sync_compress": "sync_compress.cu",
            "alltoall_put": "alltoall_put.cu",
            "drop_set": "drop_set.cu",
            "sync_round": "sync_round.cu",
            "rescal_step": "rescal_step.cu"}

# launches per kernel since the last reset_launches(), counted by the
# wrappers (chip_smoke.py reads them to show the main path went through
# the kernels)
LAUNCHES: Dict[str, int] = {"routed_gather": 0, "adagrad_update": 0,
                            "ordered_scatter_add": 0, "pool_eval_counts": 0,
                            "complex_step": 0, "sgns_step": 0, "mf_step": 0,
                            "gather_pool": 0, "gather_cold": 0,
                            "gather_pool_cold": 0, "write_main_rows": 0,
                            "sync_compress": 0, "alltoall_put": 0,
                            "drop_set": 0, "sync_round": 0,
                            "rescal_step": 0}
# launches made by replays of captured CUDA graphs (ops/fused.py
# run_scan): each replay adds the launches recorded at its capture. No
# wrapper runs then, so LAUNCHES does not count them.
REPLAYED: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

# segments one K1/K3 launch takes (kMaxSeg in the sources); the wrappers
# join any beyond it into the last
MAX_SEGMENTS = 8

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = REPLAYED[k] = 0


def _build_dir() -> str:
    d = os.environ.get("ADAPM_TORCH_KERNEL_DIR") or os.path.join(
        os.path.dirname(_CSRC), os.pardir, "build", "kernels")
    os.makedirs(d, exist_ok=True)
    return os.path.abspath(d)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _headers() -> bytes:
    """The shared headers' bytes, part of every library's hash."""
    out = b""
    for h in sorted(os.listdir(_CSRC)):
        if h.endswith(".cuh"):
            with open(os.path.join(_CSRC, h), "rb") as f:
                out += f.read()
    return out


def nvcc_command(src: str, out: str) -> list:
    """The nvcc line every kernel library is built with: sm_90a, with
    ptxas's registers and spills on its output; the shared headers are
    found from any directory."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-I", _CSRC, "-o", out, src]


def build() -> float:
    """Compile (or find already compiled) every kernel library and load
    it; returns the wall seconds. Idempotent and thread-safe."""
    import time
    t0 = time.perf_counter()
    with _build_lock:
        todo = {n: s for n, s in _SOURCES.items() if n not in _libs}
        if not todo:
            return 0.0
        outs, procs = {}, {}
        headers = _headers()
        for name, src in todo.items():
            path = os.path.join(_CSRC, src)
            with open(path, "rb") as f:
                tag = hashlib.sha256(f.read() + headers).hexdigest()[:16]
            out = os.path.join(_build_dir(), f"lib{name}_{tag}.so")
            outs[name] = out
            if os.path.exists(out):
                continue
            tmp = f"{out}.tmp{os.getpid()}"
            procs[name] = (subprocess.Popen(
                nvcc_command(path, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
        for name, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for {_SOURCES[name]}:\n"
                                   f"{log}")
            with open(out + ".ptxas.txt", "w") as f:
                f.write(log)
            os.replace(tmp, out)
        for name, out in outs.items():
            _libs[name] = _bind(name, ctypes.CDLL(out))
    return time.perf_counter() - t0


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    if name == "routed_gather":
        lib.adapm_routed_gather.restype = I
        lib.adapm_routed_gather.argtypes = [P] * 9 + [I, P] + [I] * 6 + [P]
    elif name == "adagrad":
        lib.adapm_adagrad_update.restype = I
        lib.adapm_adagrad_update.argtypes = [P, P, LL, P, LL, I, P, F, F,
                                              I, P]
        lib.adapm_adagrad_apply.restype = I
        lib.adapm_adagrad_apply.argtypes = [P] * 5 + [LL, F, F, P]
    elif name == "complex_step":
        lib.adapm_complex_step_smem.restype = LL
        lib.adapm_complex_step_smem.argtypes = [I, I]
        lib.adapm_complex_step.restype = I
        lib.adapm_complex_step.argtypes = [P, LL, P, P] * 4 + \
            [P, P, I, I, I, F, F, I, P]
    elif name == "rescal_step":
        lib.adapm_rescal_step_smem.restype = LL
        lib.adapm_rescal_step_smem.argtypes = [I, I]
        lib.adapm_rescal_step.restype = I
        lib.adapm_rescal_step.argtypes = [P, LL, P, P] * 4 + \
            [P, P, I, I, I, F, F, I, P]
    elif name == "sgns_step":
        lib.adapm_sgns_step.restype = I
        lib.adapm_sgns_step.argtypes = [P, LL, P, P] * 3 + [P, P, I, I, I, I,
                                                             P]
    elif name == "mf_step":
        lib.adapm_mf_step.restype = I
        lib.adapm_mf_step.argtypes = [P, LL, P, P] * 2 + [P, P, P, I, I, F,
                                                           I, P]
    elif name == "gather_pool":
        lib.adapm_gather_pool.restype = I
        lib.adapm_gather_pool.argtypes = [P] * 10 + [LL, P] + [I] * 8 + [P]
        lib.adapm_gather_pool_cold.restype = I
        lib.adapm_gather_pool_cold.argtypes = [P] * 13 + [LL, P] + [I] * 9 \
            + [P]
    elif name == "gather_cold":
        lib.adapm_gather_cold.restype = I
        lib.adapm_gather_cold.argtypes = [P] * 11 + [LL, P] + [I] * 7 + [P]
    elif name == "write_main_rows":
        lib.adapm_write_main_rows.restype = I
        lib.adapm_write_main_rows.argtypes = [P] * 6 + [I] * 6 + [P]
    elif name == "sync_compress":
        lib.adapm_sync_compress.restype = I
        lib.adapm_sync_compress.argtypes = [P] * 3 + [LL, I, I, I, F] + \
            [P] * 4 + [I, I, P]
    elif name == "alltoall_put":
        lib.adapm_alltoall_put.restype = I
        lib.adapm_alltoall_put.argtypes = [P, P, I, LL, LL, P]
        lib.adapm_a2a_alloc.restype = I
        lib.adapm_a2a_alloc.argtypes = [LL, ctypes.POINTER(P), P]
        lib.adapm_a2a_open.restype = I
        lib.adapm_a2a_open.argtypes = [P, ctypes.POINTER(P)]
        lib.adapm_a2a_close.restype = I
        lib.adapm_a2a_close.argtypes = [P]
        lib.adapm_a2a_free.restype = I
        lib.adapm_a2a_free.argtypes = [P]
    elif name == "drop_set":
        lib.adapm_drop_set.restype = I
        lib.adapm_drop_set.argtypes = [P] * 5 + [I] * 5 + [P]
        lib.adapm_drop_set_install.restype = I
        lib.adapm_drop_set_install.argtypes = [P] * 9 + [I, I, P] + [I] * 5 \
            + [P]
        lib.adapm_drop_set_zero.restype = I
        lib.adapm_drop_set_zero.argtypes = [P] * 3 + [I] * 5 + [P]
    elif name == "sync_round":
        lib.adapm_sync_round.restype = I
        lib.adapm_sync_round.argtypes = [P] * 7 + [I] * 6 + [P, P, I, F, I,
                                                              P]
    elif name == "ordered_scatter":
        lib.adapm_flat_targets.restype = I
        lib.adapm_flat_targets.argtypes = [P, P, P, I, P, I, I, P]
        lib.adapm_ordered_fold.restype = I
        lib.adapm_ordered_fold.argtypes = [P] * 4 + [LL, I, I, I, P]
        lib.adapm_ordered_fold_grid.restype = I
        lib.adapm_ordered_fold_grid.argtypes = [LL, I, I, P]
    else:
        lib.adapm_pool_eval_counts.restype = I
        lib.adapm_pool_eval_counts.argtypes = [P, I, I, I, I, P, P, LL, P, LL,
                                               P, P, P, P, P] + [I] * 8 + \
            [P, P, P]
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build()
    return _libs[name]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _on_cuda(*ts) -> bool:
    """True when every given tensor is on one CUDA device, False when all
    are on the CPU; anything else is an error."""
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _aligned16(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


# ---------------------------------------------------------------------------
# K1 routed_gather
# ---------------------------------------------------------------------------


def _fill_gather_plain(pool: torch.Tensor, sh: torch.Tensor,
                       sl: torch.Tensor) -> torch.Tensor:
    """`pool.at[sh, sl].get(mode="fill", fill_value=0)`: any out-of-range
    coordinate (negative, or past the pool) reads a zero row."""
    S, R, L = pool.shape
    sh, sl = sh.long(), sl.long()
    ok = (sh >= 0) & (sh < S) & (sl >= 0) & (sl < R)
    flat = torch.where(ok, sh * R + sl, torch.zeros_like(sh))
    rows = pool.reshape(S * R, L).index_select(0, flat)
    return torch.where(ok[:, None], rows, torch.zeros_like(rows))


def routed_gather_plain(main, cache, delta, o_sh, o_sl, c_sh=None,
                        c_sl=None, use_c=None) -> torch.Tensor:
    """The plain PyTorch version of K1 (same semantics, any device)."""
    m = _fill_gather_plain(main, o_sh, o_sl)
    if cache is None:
        return m
    c = _fill_gather_plain(cache, c_sh, c_sl) + \
        _fill_gather_plain(delta, c_sh, c_sl)
    return torch.where(use_c[:, None], c, m)


def _cat_segments(segments):
    """The segments' coordinate tuples joined into one (batch order:
    segment order, then position)."""
    if len(segments) == 1:
        return tuple(segments[0])
    return tuple(torch.cat([p.reshape(-1) for p in parts])
                 for parts in zip(*segments))


def _pack_segments(segments):
    """At most MAX_SEGMENTS segments (the kernels' table size): the tail
    beyond it is joined into the last one."""
    segments = [tuple(s) for s in segments]
    if len(segments) <= MAX_SEGMENTS:
        return segments
    return segments[:MAX_SEGMENTS - 1] + [
        _cat_segments(segments[MAX_SEGMENTS - 1:])]


def _ptr_table(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def routed_gather(main, cache, delta, o_sh, o_sl, c_sh=None, c_sl=None,
                  use_c=None) -> torch.Tensor:
    """out[i] = use_c[i] ? fill(cache+delta)[c_sh, c_sl] : fill(main)[o_sh,
    o_sl] over [S, slots, L] f32 pools and [n] int32 coordinates;
    `cache is None` is the main-only form. Returns a new [n, L]."""
    seg = (o_sh, o_sl) + ((c_sh, c_sl, use_c) if cache is not None else ())
    return routed_gather_segments(main, cache, delta, [seg])


def routed_gather_segments_plain(main, cache, delta,
                                 segments) -> torch.Tensor:
    """The plain version of the multi-segment K1: the plain gather of the
    joined coordinates."""
    return routed_gather_plain(main, cache, delta,
                               *_cat_segments(segments))


def routed_gather_segments(main, cache, delta, segments) -> torch.Tensor:
    """K1 over an ordered list of coordinate segments (the roles of one
    pool class) in one launch: each segment is (o_sh, o_sl) in the
    main-only form (`cache is None`), else (o_sh, o_sl, c_sh, c_sl,
    use_c), each of them [n_s]. Returns a new [sum n_s, L]; segment s's
    rows are the row slice after the earlier segments'."""
    full = cache is not None
    width = 5 if full else 2
    _require(len(segments) > 0 and all(len(s) == width for s in segments),
             f"routed_gather: segments must be {width}-tuples of "
             "coordinates")
    if not _on_cuda(main, cache, delta, *[t for s in segments for t in s]):
        return routed_gather_segments_plain(main, cache, delta, segments)
    S, R, L = main.shape
    for t in (main,) + ((cache, delta) if full else ()):
        _require(t.dtype == torch.float32 and t.dim() == 3
                 and t.is_contiguous() and t.shape[-1] == L,
                 "routed_gather: pools must be contiguous f32 [S, slots, L]")
    for seg in segments:
        n_s = seg[0].numel()
        for t in seg[:4]:
            _require(t.dtype == torch.int32 and t.dim() == 1
                     and t.numel() == n_s and t.is_contiguous(),
                     "routed_gather: coordinates must be contiguous int32 "
                     "[n]")
        if full:
            _require(seg[4].dtype == torch.bool and seg[4].numel() == n_s
                     and seg[4].is_contiguous(),
                     "routed_gather: use_c must be contiguous bool [n]")
    cS = cR = 0
    if full:
        _require(cache.shape == delta.shape,
                 "routed_gather: cache and delta shapes differ")
        cS, cR = cache.shape[0], cache.shape[1]
    n = sum(s[0].numel() for s in segments)
    out = torch.empty((n, L), dtype=torch.float32, device=main.device)
    if n == 0:
        return out
    segs = _pack_segments(segments)
    cols = list(zip(*segs))
    tables = [_ptr_table(c) for c in cols] + [None] * (5 - len(cols))
    sizes = (ctypes.c_longlong * len(segs))(*[s[0].numel() for s in segs])
    vec = int(L % 4 == 0 and _aligned16(main, cache, delta, out))
    rc = _lib("routed_gather").adapm_routed_gather(
        _ptr(main), _ptr(cache), _ptr(delta), *tables, sizes, len(segs),
        _ptr(out), S, R, cS, cR, L, vec, _stream())
    LAUNCHES["routed_gather"] += 1
    _check(rc, "routed_gather")
    return out


# ---------------------------------------------------------------------------
# K2 adagrad_update / adagrad_apply
# ---------------------------------------------------------------------------


def adagrad_update_plain(g: torch.Tensor, acc: torch.Tensor, lr: float,
                         eps: float) -> torch.Tensor:
    """The plain version of K2's fused-step form."""
    g2 = g * g
    upd = (-lr) * g * torch.rsqrt(acc + g2 + eps)
    return torch.cat([upd, g2], dim=-1)


def adagrad_update(g: torch.Tensor, acc: torch.Tensor,
                   lr: Optional[float] = None, eps: Optional[float] = None,
                   out: Optional[torch.Tensor] = None,
                   lr_eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Delta row of the fused step: [-lr*g*rsqrt(acc + g^2 + eps) | g^2]
    for g [n, D] and acc [n, D] (acc may be the accumulator half of the
    gathered [n, 2D] rows: only its last dim must be contiguous). lr and
    eps are floats, or `lr_eps` is (lr, eps) as a contiguous f32 [2] on
    g's device, which the kernel reads (the fused step's, as K5 reads
    it: a captured graph follows it). Writes into `out` (a contiguous
    f32 [n, 2D], e.g. a row slice of the step's update buffer) when
    given, else into a new [n, 2D]; returns it."""
    _require((lr_eps is None) == (lr is not None and eps is not None),
             "adagrad_update: give lr and eps, or lr_eps")
    if lr_eps is not None:
        _require(lr_eps.dtype == torch.float32 and lr_eps.numel() == 2
                 and lr_eps.is_contiguous(),
                 "adagrad_update: lr_eps must be a contiguous f32 [2]")
    if out is not None:
        _require(out.dtype == torch.float32 and out.is_contiguous()
                 and g.dim() == 2
                 and tuple(out.shape) == (g.shape[0], 2 * g.shape[1]),
                 "adagrad_update: out must be contiguous f32 [n, 2D]")
    if not _on_cuda(g, acc, out, lr_eps):
        if lr_eps is not None:
            lr, eps = lr_eps.tolist()
        upd = adagrad_update_plain(g, acc, lr, eps)
        return upd if out is None else out.copy_(upd)
    _require(g.dtype == torch.float32 and acc.dtype == torch.float32,
             "adagrad_update: f32 only")
    _require(g.dim() == 2 and acc.shape == g.shape,
             "adagrad_update: g and acc must both be [n, D]")
    _require(g.is_contiguous() and acc.stride(1) == 1,
             "adagrad_update: g must be contiguous and acc row-major")
    n, D = g.shape
    upd = out if out is not None else torch.empty(
        (n, 2 * D), dtype=torch.float32, device=g.device)
    if n == 0:
        return upd
    vec = int(D % 4 == 0 and acc.stride(0) % 4 == 0
              and _aligned16(g, acc, upd))
    rc = _lib("adagrad").adapm_adagrad_update(
        _ptr(g), _ptr(acc), acc.stride(0), _ptr(upd), n, D, _ptr(lr_eps),
        float(lr or 0.0), float(eps or 0.0), vec, _stream())
    LAUNCHES["adagrad_update"] += 1
    _check(rc, "adagrad_update")
    return upd


def adagrad_apply_plain(g, emb, acc, lr: float, eps: float):
    """The plain version of K2's standalone form."""
    acc2 = acc + g * g
    return emb - lr * g * torch.rsqrt(acc2 + eps), acc2


def adagrad_apply(g: torch.Tensor, emb: torch.Tensor, acc: torch.Tensor,
                  lr: float, eps: float = 1e-10):
    """Standalone AdaGrad over [n, L] rows (the Pallas adagrad_apply
    contract): acc' = acc + g^2, emb' = emb - lr*g*rsqrt(acc' + eps).
    Returns (emb', acc') as new tensors."""
    if not _on_cuda(g, emb, acc):
        return adagrad_apply_plain(g, emb, acc, lr, eps)
    for t in (g, emb, acc):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and t.shape == g.shape,
                 "adagrad_apply: contiguous f32 tensors of one shape")
    emb_out, acc_out = torch.empty_like(emb), torch.empty_like(acc)
    if g.numel() == 0:
        return emb_out, acc_out
    rc = _lib("adagrad").adapm_adagrad_apply(
        _ptr(g), _ptr(emb), _ptr(acc), _ptr(emb_out), _ptr(acc_out),
        g.numel(), float(lr), float(eps), _stream())
    LAUNCHES["adagrad_update"] += 1
    _check(rc, "adagrad_apply")
    return emb_out, acc_out


# ---------------------------------------------------------------------------
# K3 ordered_scatter_add
# ---------------------------------------------------------------------------


def _flat_targets_plain(pool: torch.Tensor, sh: torch.Tensor,
                        sl: torch.Tensor) -> torch.Tensor:
    """Flat row index per entry (int64); out-of-range entries get S*R
    (one past the last row), which the scatter drops."""
    S, R, _ = pool.shape
    sh, sl = sh.long(), sl.long()
    ok = (sh >= 0) & (sh < S) & (sl >= 0) & (sl < R)
    return torch.where(ok, sh * R + sl, torch.full_like(sh, S * R))


def ordered_scatter_order(pool: torch.Tensor, segments):
    """K3's ordering pass over the joined (sh, sl) segments: the flat
    targets (int32 on the card), stably sorted, and the int64 permutation
    that sorts them. Ordering, not arithmetic: each target's occurrences
    become one run that keeps batch order; out-of-range entries (target
    S*R) sort last. The flat targets come from the `flat_targets` kernel
    on the card; the sort is torch.sort."""
    _require(len(segments) > 0 and all(len(s) == 2 for s in segments),
             "ordered_scatter_add: segments must be (sh, sl) pairs")
    if not _on_cuda(pool, *[t for s in segments for t in s]):
        flat = _flat_targets_plain(pool, *_cat_segments(segments))
        return torch.sort(flat, stable=True)
    S, R, _ = pool.shape
    _require(S * R < 2**31 - 1,
             "ordered_scatter_add: the pool has too many rows for int32 "
             "targets")
    for sh, sl in segments:
        _require(sh.dtype == torch.int32 and sl.dtype == torch.int32
                 and sl.numel() == sh.numel()
                 and sh.is_contiguous() and sl.is_contiguous(),
                 "ordered_scatter_add: coordinates must be contiguous "
                 "int32 [n]")
    segs = _pack_segments(segments)
    n = sum(s[0].numel() for s in segs)
    flat = torch.empty(n, dtype=torch.int32, device=pool.device)
    if n:
        sh, sl = zip(*segs)
        sizes = (ctypes.c_longlong * len(segs))(*[t.numel() for t in sh])
        rc = _lib("ordered_scatter").adapm_flat_targets(
            _ptr_table(sh), _ptr_table(sl), sizes, len(segs), _ptr(flat),
            S, R, _stream())
        _check(rc, "ordered_scatter_add (flat targets)")
    return torch.sort(flat, stable=True)


def ordered_scatter_fold_plain(pool, sf, perm, vals) -> None:
    """The plain version of K3's fold: the sorted runs folded one
    occurrence rank at a time (the k-th occurrences of all targets are
    distinct rows, so each rank is one duplicate-free indexed add)."""
    S, R, L = pool.shape
    n = sf.numel()
    if n == 0:
        return
    sf = sf.long()
    pos = torch.arange(n, device=sf.device)
    head = torch.ones(n, dtype=torch.bool, device=sf.device)
    head[1:] = sf[1:] != sf[:-1]
    run_start = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)),
                             dim=0).values
    rank = pos - run_start
    keep = sf < S * R
    rows = pool.view(S * R, L)
    for k in range(int(rank[keep].max()) + 1 if bool(keep.any()) else 0):
        sel = keep & (rank == k)
        t = sf[sel]
        rows[t] = rows[t] + vals[perm[sel]]


def ordered_scatter_fold(pool: torch.Tensor, sf: torch.Tensor,
                         perm: torch.Tensor, vals: torch.Tensor) -> None:
    """K3's fold, in place, given its ordering pass (ordered_scatter_order):
    every run of equal in-range targets adds its value rows into the
    stored row in run order."""
    if not _on_cuda(pool, sf, perm, vals):
        return ordered_scatter_fold_plain(pool, sf, perm, vals)
    S, R, L = pool.shape
    n = sf.numel()
    _require(pool.dtype == torch.float32 and pool.is_contiguous(),
             "ordered_scatter_add: pool must be contiguous f32")
    _require(sf.dtype == torch.int32 and perm.dtype == torch.int64
             and perm.numel() == n and sf.is_contiguous()
             and perm.is_contiguous(),
             "ordered_scatter_add: sorted targets must be int32 [n] and "
             "the permutation int64 [n]")
    _require(vals.dtype == torch.float32 and vals.is_contiguous()
             and tuple(vals.shape) == (n, L),
             "ordered_scatter_add: vals must be contiguous f32 [n, L]")
    if n == 0:
        return
    vec = int(L % 4 == 0 and _aligned16(pool, vals))
    rc = _lib("ordered_scatter").adapm_ordered_fold(
        _ptr(pool), _ptr(sf), _ptr(perm), _ptr(vals), n, S * R, L, vec,
        _stream())
    LAUNCHES["ordered_scatter_add"] += 1
    _check(rc, "ordered_scatter_add")


def ordered_scatter_add_plain(pool, sh, sl, vals) -> None:
    """The plain version of K3 (any device)."""
    sf, perm = torch.sort(_flat_targets_plain(pool, sh, sl), stable=True)
    ordered_scatter_fold_plain(pool, sf, perm, vals)


def ordered_scatter_add_segments_plain(pool, segments, vals) -> None:
    """The plain version of the multi-segment K3: the plain scatter of the
    joined coordinates."""
    ordered_scatter_add_plain(pool, *_cat_segments(segments), vals)


def ordered_scatter_add(pool: torch.Tensor, sh: torch.Tensor,
                        sl: torch.Tensor, vals: torch.Tensor) -> None:
    """In place: pool[sh[i], sl[i]] += vals[i] for every in-range entry,
    duplicates folded in batch order (np.add.at). pool [S, R, L] f32,
    sh/sl [n] int32, vals [n, L] f32."""
    ordered_scatter_add_segments(pool, [(sh, sl)], vals)


def ordered_scatter_add_segments(pool: torch.Tensor, segments,
                                 vals: torch.Tensor) -> None:
    """K3 over an ordered list of (sh, sl) coordinate segments (the
    trainable roles of one pool class) and one [sum n_s, L] value buffer,
    as one batch: bit for bit one ordered_scatter_add per segment, in
    list order. One ordering pass and one fold launch."""
    if not _on_cuda(pool, vals, *[t for s in segments for t in s]):
        return ordered_scatter_add_segments_plain(pool, segments, vals)
    _require(pool.dtype == torch.float32 and pool.is_contiguous(),
             "ordered_scatter_add: pool must be contiguous f32")
    n = sum(s[0].numel() for s in segments)
    _require(vals.dtype == torch.float32 and vals.is_contiguous()
             and tuple(vals.shape) == (n, pool.shape[-1]),
             "ordered_scatter_add: vals must be contiguous f32 [n, L]")
    if n == 0:
        return
    sf, perm = ordered_scatter_order(pool, segments)
    ordered_scatter_fold(pool, sf, perm, vals)


# ---------------------------------------------------------------------------
# K8 gather_pool
# ---------------------------------------------------------------------------


def gather_pool_plain(main, cache, delta, o_sh, o_sl, c_sh, c_sl, use_c,
                      seg, out, pooling: str = "sum") -> torch.Tensor:
    """The plain version of K8 (any device): K1's plain read of the
    member rows, K3's plain ordered fold of them into `out` (batch order,
    out-of-range seg dropped), then for mean one division per bag by its
    member count, zeros for an empty bag. In place into `out`; returns
    it."""
    rows = routed_gather_plain(main, cache, delta, o_sh, o_sl, c_sh, c_sl,
                               use_c)
    return _pool_rows_plain(rows, seg, out, pooling)


def _pool_rows_plain(rows, seg, out, pooling: str) -> torch.Tensor:
    """K8's and K10's plain pooling of read member rows into `out`."""
    nb = out.shape[0]
    pool = out.view(1, nb, -1)
    sf, perm = torch.sort(_flat_targets_plain(pool, torch.zeros_like(seg),
                                              seg), stable=True)
    ordered_scatter_fold_plain(pool, sf, perm, rows)
    if pooling == "mean":
        s = seg.long()
        cnt = torch.bincount(s[(s >= 0) & (s < nb)], minlength=nb).to(
            out.dtype)[:, None]
        out.copy_(torch.where(cnt > 0, out / cnt.clamp(min=1),
                              torch.zeros_like(out)))
    return out


def gather_pool(main, cache, delta, o_sh, o_sl, c_sh, c_sl, use_c, seg,
                out: torch.Tensor, pooling: str = "sum",
                sorted_seg: bool = False) -> torch.Tensor:
    """Fused embedding-bag read, in place: out[seg[i]] += row[i] in batch
    order for every member i whose seg is in [0, nbags), where row[i] is
    K1's routed read (cache+delta where use_c, else main); for "mean",
    each bag is then divided once by its member count (zeros for an
    empty bag). Pools [S, slots, L] f32, coordinates and seg [n] int32,
    use_c [n] bool, out [nbags, L] f32 (each bag's starting value).
    `sorted_seg` says seg is non-decreasing, as the serving path builds
    it; otherwise the members are ordered first by K3's stable ordering
    pass. Returns `out`."""
    _require(pooling in ("sum", "mean"),
             f"gather_pool: pooling must be 'sum' or 'mean' (got "
             f"{pooling!r})")
    if not _on_cuda(main, cache, delta, o_sh, o_sl, c_sh, c_sl, use_c, seg,
                    out):
        return gather_pool_plain(main, cache, delta, o_sh, o_sl, c_sh, c_sl,
                                 use_c, seg, out, pooling)
    S, R, L = main.shape
    _check_pool_args("gather_pool", main, cache, delta, o_sh, o_sl, c_sh,
                     c_sl, use_c, seg, out)
    n, nb = seg.numel(), out.shape[0]
    if nb == 0:
        return out
    seg, perm = _bag_order(out, seg, sorted_seg)
    vec = int(L % 4 == 0 and _aligned16(main, cache, delta, out))
    rc = _lib("gather_pool").adapm_gather_pool(
        _ptr(main), _ptr(cache), _ptr(delta), _ptr(o_sh), _ptr(o_sl),
        _ptr(c_sh), _ptr(c_sl), _ptr(use_c), _ptr(seg), _ptr(perm), n,
        _ptr(out), nb, S, R, cache.shape[0], cache.shape[1], L,
        int(pooling == "mean"), vec, _stream())
    LAUNCHES["gather_pool"] += 1
    _check(rc, "gather_pool")
    return out


def _check_pool_args(what, main, cache, delta, o_sh, o_sl, c_sh, c_sl,
                     use_c, seg, out) -> None:
    L = main.shape[-1]
    for t in (main, cache, delta):
        _require(t.dtype == torch.float32 and t.dim() == 3
                 and t.is_contiguous() and t.shape[-1] == L,
                 f"{what}: pools must be contiguous f32 [S, slots, L]")
    _require(cache.shape == delta.shape,
             f"{what}: cache and delta shapes differ")
    n = seg.numel()
    for t in (o_sh, o_sl, c_sh, c_sl, seg):
        _require(t.dtype == torch.int32 and t.dim() == 1 and t.numel() == n
                 and t.is_contiguous(),
                 f"{what}: coordinates and seg must be contiguous int32 [n]")
    _require(use_c.dtype == torch.bool and use_c.numel() == n
             and use_c.is_contiguous(),
             f"{what}: use_c must be contiguous bool [n]")
    _require(out.dtype == torch.float32 and out.dim() == 2
             and out.shape[1] == L and out.is_contiguous(),
             f"{what}: out must be contiguous f32 [nbags, L]")


def _bag_order(out, seg, sorted_seg: bool):
    """K8's member order: (seg, None) when seg is non-decreasing, else
    K3's stable ordering of the members by bag and its permutation."""
    if sorted_seg or seg.numel() == 0:
        return seg, None
    nb, L = out.shape
    return ordered_scatter_order(out.view(1, nb, L),
                                 [(torch.zeros_like(seg), seg)])


# ---------------------------------------------------------------------------
# The wire formats (tier/quant.py) and K9-K12
# ---------------------------------------------------------------------------

# quant.cuh's wire modes; the wire rows' dtypes
WIRE_MODES = {"fp32": 1, "fp16": 2, "int8": 3}
WIRE_DTYPES = {"fp32": torch.float32, "fp16": torch.float16,
               "int8": torch.int8}
# largest finite fp16 value: the wire formats clip to it before any f16
# cast (tier/quant.py F16_MAX, csrc/quant.cuh kF16Max)
F16_MAX = 65504.0


def dequantize_plain(mode: str, q: torch.Tensor,
                     scale: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 rows of wire rows `q` ([n, L]): tier/quant.py dequantize_rows
    in torch ops (the f16 convert is exact; int8 is one f32 multiply)."""
    if mode == "fp32":
        return q
    if mode == "fp16":
        return q.to(torch.float32)
    return q.to(torch.float32) * scale[:, None]


def _check_wire(what: str, mode: str, q, scale, n: int, L: int) -> None:
    _require(mode in WIRE_MODES, f"{what}: unknown wire mode {mode!r}")
    _require(q.dtype == WIRE_DTYPES[mode] and tuple(q.shape) == (n, L)
             and q.is_contiguous(),
             f"{what}: {mode} rows must be contiguous "
             f"{WIRE_DTYPES[mode]} [n, L]")
    if mode == "int8":
        _require(scale is not None and scale.dtype == torch.float32
                 and scale.numel() == n and scale.is_contiguous(),
                 f"{what}: int8 rows need a contiguous f32 scale [n]")


def gather_cold_plain(main, cache, delta, o_sh, o_row, c_sh, c_sl, use_c,
                      mode, cold, scale, use_cold) -> torch.Tensor:
    """The plain version of K9 (any device): K1's plain read with each
    use_cold entry's main row replaced by its dequantized wire row (a
    select), and cache+delta over both where use_c."""
    m = _fill_gather_plain(main, o_sh, o_row)
    m = torch.where(use_cold[:, None], dequantize_plain(mode, cold, scale),
                    m)
    c = _fill_gather_plain(cache, c_sh, c_sl) + \
        _fill_gather_plain(delta, c_sh, c_sl)
    return torch.where(use_c[:, None], c, m)


def gather_cold(main, cache, delta, o_sh, o_row, c_sh, c_sl, use_c, mode,
                cold, scale, use_cold) -> torch.Tensor:
    """K9: out[i] = use_c[i] ? fill(cache+delta)[c_sh, c_sl]
    : use_cold[i] ? deq(cold[i]) : fill(main)[o_sh, o_row]. Pools
    [S, rows, L] f32, coordinates [n] int32, masks [n] bool, cold [n, L]
    in `mode` (fp32, fp16, int8 with scale [n] f32, else scale None).
    Returns a new [n, L]."""
    if not _on_cuda(main, cache, delta, o_sh, o_row, c_sh, c_sl, use_c,
                    cold, scale, use_cold):
        return gather_cold_plain(main, cache, delta, o_sh, o_row, c_sh,
                                 c_sl, use_c, mode, cold, scale, use_cold)
    S, R, L = main.shape
    n = o_sh.numel()
    for t in (main, cache, delta):
        _require(t.dtype == torch.float32 and t.dim() == 3
                 and t.is_contiguous() and t.shape[-1] == L,
                 "gather_cold: pools must be contiguous f32 [S, rows, L]")
    for t in (o_sh, o_row, c_sh, c_sl):
        _require(t.dtype == torch.int32 and t.numel() == n
                 and t.is_contiguous(),
                 "gather_cold: coordinates must be contiguous int32 [n]")
    for t in (use_c, use_cold):
        _require(t.dtype == torch.bool and t.numel() == n
                 and t.is_contiguous(),
                 "gather_cold: masks must be contiguous bool [n]")
    _check_wire("gather_cold", mode, cold, scale, n, L)
    out = torch.empty((n, L), dtype=torch.float32, device=main.device)
    if n == 0:
        return out
    vec = int(L % 4 == 0 and _aligned16(main, cache, delta, out, cold))
    rc = _lib("gather_cold").adapm_gather_cold(
        _ptr(main), _ptr(cache), _ptr(delta), _ptr(o_sh), _ptr(o_row),
        _ptr(c_sh), _ptr(c_sl), _ptr(use_c), _ptr(cold), _ptr(scale),
        _ptr(use_cold), n, _ptr(out), S, R, cache.shape[0], cache.shape[1],
        L, WIRE_MODES[mode], vec, _stream())
    LAUNCHES["gather_cold"] += 1
    _check(rc, "gather_cold")
    return out


def gather_pool_cold_plain(main, cache, delta, o_sh, o_row, c_sh, c_sl,
                           use_c, mode, cold, scale, use_cold, seg, out,
                           pooling: str = "sum") -> torch.Tensor:
    """The plain version of K10 (any device): K9's plain read pooled as
    K8's plain version pools."""
    rows = gather_cold_plain(main, cache, delta, o_sh, o_row, c_sh, c_sl,
                             use_c, mode, cold, scale, use_cold)
    return _pool_rows_plain(rows, seg, out, pooling)


def gather_pool_cold(main, cache, delta, o_sh, o_row, c_sh, c_sl, use_c,
                     mode, cold, scale, use_cold, seg, out: torch.Tensor,
                     pooling: str = "sum",
                     sorted_seg: bool = False) -> torch.Tensor:
    """K10: K8's fused bag read (gather_pool) where each member's row is
    K9's: a use_cold member reads its dequantized row of the staged
    [n, L] wire buffer `cold`. In place into `out`; returns it."""
    _require(pooling in ("sum", "mean"),
             f"gather_pool_cold: pooling must be 'sum' or 'mean' (got "
             f"{pooling!r})")
    if not _on_cuda(main, cache, delta, o_sh, o_row, c_sh, c_sl, use_c,
                    cold, scale, use_cold, seg, out):
        return gather_pool_cold_plain(main, cache, delta, o_sh, o_row, c_sh,
                                      c_sl, use_c, mode, cold, scale,
                                      use_cold, seg, out, pooling)
    S, R, L = main.shape
    _check_pool_args("gather_pool_cold", main, cache, delta, o_sh, o_row,
                     c_sh, c_sl, use_c, seg, out)
    n, nb = seg.numel(), out.shape[0]
    _require(use_cold.dtype == torch.bool and use_cold.numel() == n
             and use_cold.is_contiguous(),
             "gather_pool_cold: use_cold must be contiguous bool [n]")
    _check_wire("gather_pool_cold", mode, cold, scale, n, L)
    if nb == 0:
        return out
    seg, perm = _bag_order(out, seg, sorted_seg)
    vec = int(L % 4 == 0 and _aligned16(main, cache, delta, out, cold))
    rc = _lib("gather_pool").adapm_gather_pool_cold(
        _ptr(main), _ptr(cache), _ptr(delta), _ptr(o_sh), _ptr(o_row),
        _ptr(c_sh), _ptr(c_sl), _ptr(use_c), _ptr(cold), _ptr(scale),
        _ptr(use_cold), _ptr(seg), _ptr(perm), n, _ptr(out), nb, S, R,
        cache.shape[0], cache.shape[1], L, int(pooling == "mean"),
        WIRE_MODES[mode], vec, _stream())
    LAUNCHES["gather_pool_cold"] += 1
    _check(rc, "gather_pool_cold")
    return out


def set_winners(pool: torch.Tensor, sh: torch.Tensor, sl: torch.Tensor):
    """The rows a drop-mode set writes: (flat target rows, entry index)
    of each winning entry — out-of-range entries never win and, of
    several entries naming one row, the last in batch order does (one
    stable sort). An indexed write with duplicate indices has no defined
    winner on CUDA, so every set resolves its winners first."""
    S, R, _ = pool.shape
    sh, sl = sh.long(), sl.long()
    ok = (sh >= 0) & (sh < S) & (sl >= 0) & (sl < R)
    flat = torch.where(ok, sh * R + sl, torch.full_like(sh, -1))
    sf, order = torch.sort(flat, stable=True)
    win = torch.ones_like(sf, dtype=torch.bool)
    win[:-1] = sf[:-1] != sf[1:]
    win &= sf >= 0
    return sf[win], order[win]


def write_main_rows_plain(main, sh, row, mode, q, scale) -> torch.Tensor:
    """The plain version of K11 (any device): dequantize, then the
    drop-mode set (last wins). In place; returns `main`."""
    S, R, L = main.shape
    tgt, keep = set_winners(main, sh, row)
    main.view(S * R, L)[tgt] = dequantize_plain(mode, q, scale)[keep]
    return main


# the claim scratch of K11, K14 and K15: int32 words, all -1 between
# calls, by (kernel, device, stream, words), one word per pool row unless
# the kernel asks for more. Calls on one stream run in order and each
# leaves it all -1, so pools of one size share it there. A graph holds the
# address of what its capture allocates, so a set inside a captured
# window must find its scratch already made.
_claims: Dict[tuple, torch.Tensor] = {}
_claims_lock = threading.Lock()
# K15's per-call scratch by (kernel, device, stream): words that hold
# nothing between calls, grown outside a capture; an outgrown one stays
# referenced, since a captured graph may hold its address
_entries: Dict[tuple, torch.Tensor] = {}
_entries_outgrown: list = []


def _claim_key(kernel: str, pool: torch.Tensor, stream,
               words: Optional[int] = None) -> tuple:
    return (kernel, pool.device, stream.cuda_stream,
            pool.shape[0] * pool.shape[1] if words is None else words)


def _no_capture(kernel: str, what: str) -> None:
    _require(not torch.cuda.is_current_stream_capturing(),
             f"{kernel}: no {what} on this stream; make it before a CUDA "
             "graph capture (a graph keeps its address)")


def _claim_scratch(kernel: str, pool: torch.Tensor, stream,
                   words: Optional[int] = None) -> torch.Tensor:
    key = _claim_key(kernel, pool, stream, words)
    claim = _claims.get(key)
    if claim is None:
        with _claims_lock:
            claim = _claims.get(key)
            if claim is None:
                _no_capture(kernel, f"claim scratch of {key[3]} words")
                claim = _claims[key] = torch.full(
                    (key[3],), -1, dtype=torch.int32, device=pool.device)
    return claim


def _entry_scratch(kernel: str, pool: torch.Tensor, stream,
                   words: int) -> torch.Tensor:
    key = (kernel, pool.device, stream.cuda_stream)
    buf = _entries.get(key)
    if buf is None or buf.numel() < words:
        with _claims_lock:
            buf = _entries.get(key)
            if buf is None or buf.numel() < words:
                _no_capture(kernel, f"scratch of {words} words")
                if buf is not None:
                    _entries_outgrown.append(buf)
                buf = _entries[key] = torch.empty(
                    max(words, 0 if buf is None else 2 * buf.numel()),
                    dtype=torch.int32, device=pool.device)
    return buf


def write_main_rows(main, sh, row, mode, q, scale=None) -> torch.Tensor:
    """K11: main.at[sh, row].set(deq(q), mode="drop") in place, q [b, L]
    in `mode` (int8 with scale [b] f32), sh and row int32. One call is
    two launches, the claim and the write (csrc/write_main_rows.cu),
    counted as one. Returns `main`."""
    if not _on_cuda(main, sh, row, q, scale):
        return write_main_rows_plain(main, sh, row, mode, q, scale)
    S, R, L = main.shape
    _require(main.dtype == torch.float32 and main.is_contiguous(),
             "write_main_rows: the pool must be contiguous f32")
    _require(sh.dtype == row.dtype == torch.int32 and sh.is_contiguous()
             and row.is_contiguous(),
             "write_main_rows: sh and row must be contiguous int32")
    _require(sh.numel() == row.numel() == q.shape[0],
             "write_main_rows: one coordinate pair per wire row")
    _check_wire("write_main_rows", mode, q, scale, q.shape[0], L)
    m = q.shape[0]
    if m == 0:
        return main
    _require(m <= 2**30, "write_main_rows: at most 2**30 rows a call")
    stream = torch.cuda.current_stream(main.device)
    claim = _claim_scratch("write_main_rows", main, stream)
    vec = int(L % 4 == 0 and _aligned16(main, q))
    rc = _lib("write_main_rows").adapm_write_main_rows(
        _ptr(main), _ptr(claim), _ptr(sh), _ptr(row), _ptr(q), _ptr(scale),
        m, S, R, L, WIRE_MODES[mode], vec, stream.cuda_stream)
    LAUNCHES["write_main_rows"] += 1
    if rc != 0:
        # a write that never ran leaves the scratch claimed
        _claims.pop(_claim_key("write_main_rows", main, stream), None)
    _check(rc, "write_main_rows")
    return main


# ---------------------------------------------------------------------------
# K14 drop_set
# ---------------------------------------------------------------------------

# out-of-range slot for a held replica of a thresholded round (the port's
# padding sentinel, device/torchport.py OOB)
_OOB = 2**31 - 2


def drop_set_plain(pool, sh, sl, vals) -> None:
    """The plain version of K14's first form (any device): the winners
    resolved with one stable sort (set_winners), then one indexed write.
    In place."""
    S, R, L = pool.shape
    tgt, keep = set_winners(pool, sh, sl)
    pool.view(S * R, L)[tgt] = vals[keep]


def drop_set_install_plain(cache, delta, c_sh, c_sl, rows=None, src=None,
                           resid=None) -> None:
    """The plain version of K14's install form (any device): the source
    rows (`rows`, or the fill-read of `src` = (pool, o_sh, o_sl)) set into
    `cache`, and `resid` (zeros when None) into `delta`, at (c_sh, c_sl)."""
    if rows is None:
        rows = _fill_gather_plain(*src)
    drop_set_plain(cache, c_sh, c_sl, rows)
    drop_set_plain(delta, c_sh, c_sl,
                   torch.zeros_like(rows) if resid is None else resid)


def drop_set_zero_plain(pool, sh, sl) -> None:
    """The plain version of K14's zero form (any device)."""
    drop_set_plain(pool, sh, sl, torch.zeros(
        (sh.numel(), pool.shape[-1]), dtype=pool.dtype, device=pool.device))


def _check_set(what: str, pool, sh, sl) -> int:
    """The checks K14's forms share; returns the entry count."""
    S, R, _ = pool.shape
    _require(pool.dtype == torch.float32 and pool.is_contiguous(),
             f"{what}: the pools must be contiguous f32")
    _require(sh.dtype == sl.dtype == torch.int32 and sh.is_contiguous()
             and sl.is_contiguous() and sh.numel() == sl.numel(),
             f"{what}: coordinates must be contiguous int32 [m]")
    _require(S * R < 2**31 - 1,
             f"{what}: the pool has too many rows for int32 targets")
    _require(sh.numel() <= 2**30, f"{what}: at most 2**30 entries a call")
    return sh.numel()


def _check_src_rows(what: str, t, m: int, L: int) -> None:
    _require(t is None or (t.dtype == torch.float32 and t.is_contiguous()
                           and tuple(t.shape) == (m, L)),
             f"{what}: source rows must be contiguous f32 [m, L]")


def _set_call(fn, what: str, pool, stream, *args) -> None:
    rc = fn(*args)
    LAUNCHES["drop_set"] += 1
    if rc != 0:
        # a write that never ran leaves the scratch claimed
        _claims.pop(_claim_key("drop_set", pool, stream), None)
    _check(rc, what)


def drop_set(pool, sh, sl, vals) -> None:
    """K14: pool.at[sh, sl].set(vals, mode="drop") in place over an
    [S, R, L] f32 pool, int32 coordinates and [m, L] f32 rows: an
    out-of-range entry drops and, of several naming one row, the last in
    batch order wins (csrc/drop_set.cu, form 1: a claim and a write
    launch, counted as one)."""
    if not _on_cuda(pool, sh, sl, vals):
        return drop_set_plain(pool, sh, sl, vals)
    m = _check_set("drop_set", pool, sh, sl)
    S, R, L = pool.shape
    _check_src_rows("drop_set", vals, m, L)
    if m == 0:
        return
    stream = torch.cuda.current_stream(pool.device)
    claim = _claim_scratch("drop_set", pool, stream)
    vec = int(L % 4 == 0 and _aligned16(pool, vals))
    _set_call(_lib("drop_set").adapm_drop_set, "drop_set", pool, stream,
              _ptr(pool), _ptr(claim), _ptr(sh), _ptr(sl), _ptr(vals), m, S,
              R, L, vec, stream.cuda_stream)


def drop_set_install(cache, delta, c_sh, c_sl, rows=None, src=None,
                     resid=None) -> None:
    """K14's install form, in place: one claim over (c_sh, c_sl) of the
    [S, C, L] f32 cache/delta pair; each winner sets its source row into
    `cache` and its row of `resid` ([m, L] f32; zeros when None) into
    `delta`. The source is `rows` ([m, L] f32) or, with `src` = (pool,
    o_sh, o_sl), the fill-read of another pool at int32 coordinates, read
    where it lies (a zero row out of range). One claim and one write
    launch, counted as one."""
    _require((rows is None) != (src is None),
             "drop_set_install: give the source rows or the pool to read "
             "them from, not both")
    srcs = tuple(src) if src is not None else (None, None, None)
    if not _on_cuda(cache, delta, c_sh, c_sl, rows, resid, *srcs):
        return drop_set_install_plain(cache, delta, c_sh, c_sl, rows, src,
                                      resid)
    m = _check_set("drop_set_install", cache, c_sh, c_sl)
    S, R, L = cache.shape
    _require(delta.dtype == torch.float32 and delta.is_contiguous()
             and delta.shape == cache.shape,
             "drop_set_install: delta must be contiguous f32 of cache's "
             "shape")
    _check_src_rows("drop_set_install", rows, m, L)
    _check_src_rows("drop_set_install", resid, m, L)
    spool, o_sh, o_sl = srcs
    So = Ro = 0
    if spool is not None:
        So, Ro, Ls = spool.shape
        _require(spool.dtype == torch.float32 and spool.is_contiguous()
                 and Ls == L and spool.data_ptr() not in (
                     cache.data_ptr(), delta.data_ptr()),
                 "drop_set_install: the source pool must be contiguous f32 "
                 "of the rows' width, and neither cache nor delta")
        _require(o_sh.dtype == o_sl.dtype == torch.int32
                 and o_sh.is_contiguous() and o_sl.is_contiguous()
                 and o_sh.numel() == o_sl.numel() == m,
                 "drop_set_install: source coordinates must be contiguous "
                 "int32 [m]")
    if m == 0:
        return
    stream = torch.cuda.current_stream(cache.device)
    claim = _claim_scratch("drop_set", cache, stream)
    vec = int(L % 4 == 0 and _aligned16(cache, delta, rows, resid, spool))
    _set_call(_lib("drop_set").adapm_drop_set_install, "drop_set_install",
              cache, stream, _ptr(cache), _ptr(delta), _ptr(claim),
              _ptr(c_sh), _ptr(c_sl), _ptr(rows), _ptr(spool), _ptr(o_sh),
              _ptr(o_sl), So, Ro, _ptr(resid), m, S, R, L, vec,
              stream.cuda_stream)


def drop_set_zero(pool, sh, sl) -> None:
    """K14's zero form: every in-range (sh, sl) row of the [S, R, L] f32
    pool set to zeros, in place (one launch, no claim: each entry writes
    the same bits)."""
    if not _on_cuda(pool, sh, sl):
        return drop_set_zero_plain(pool, sh, sl)
    m = _check_set("drop_set_zero", pool, sh, sl)
    S, R, L = pool.shape
    if m == 0:
        return
    rc = _lib("drop_set").adapm_drop_set_zero(
        _ptr(pool), _ptr(sh), _ptr(sl), m, S, R, L,
        int(L % 4 == 0 and _aligned16(pool)), _stream())
    LAUNCHES["drop_set"] += 1
    _check(rc, "drop_set_zero")


# ---------------------------------------------------------------------------
# K15 sync_round
# ---------------------------------------------------------------------------


def sync_round_plain(main, cache, delta, r_sh, r_cs, o_sh, o_sl,
                     threshold: float = 0.0) -> None:
    """The plain version of K15 (any device), the JAX program's steps in
    torch ops: extract the replica deltas, hold those below the threshold
    (both coordinates OOB), merge the rest into their owners in batch
    order, re-gather the fresh owner rows, set them as bases and zero the
    deltas. In place."""
    dvals = _fill_gather_plain(delta, r_sh, r_cs)
    if threshold > 0.0:
        thr = torch.tensor(threshold, dtype=main.dtype, device=main.device)
        ship = dvals.abs().amax(dim=1) >= thr
        oob = torch.full_like(r_cs, _OOB)
        r_cs = torch.where(ship, r_cs, oob)
        o_sl = torch.where(ship, o_sl, oob)
    ordered_scatter_add_plain(main, o_sh, o_sl, dvals)
    fresh = _fill_gather_plain(main, o_sh, o_sl)
    drop_set_plain(cache, r_sh, r_cs, fresh)
    drop_set_plain(delta, r_sh, r_cs, torch.zeros_like(fresh))


def sync_round(main, cache, delta, r_sh, r_cs, o_sh, o_sl,
               threshold: float = 0.0) -> None:
    """K15: one planner round over n replicas at int32 (r_sh, r_cs) of the
    [S, C, L] f32 cache/delta pair, owned at (o_sh, o_sl) of the [So, Ro,
    L] f32 main pool, in place (sync_round_plain's contract;
    csrc/sync_round.cu): the claim, fold and clear launches, counted as
    one, ordered on the card with no sort. Its claim scratch (2 So Ro +
    S C + 1 words) and per-call scratch (2 n + 1) are made at the first
    call on a stream, outside any CUDA graph capture; a call allocates
    nothing."""
    if not _on_cuda(main, cache, delta, r_sh, r_cs, o_sh, o_sl):
        return sync_round_plain(main, cache, delta, r_sh, r_cs, o_sh, o_sl,
                                threshold)
    So, Ro, L = main.shape
    S, C, Ld = delta.shape
    n = r_sh.numel()
    _require(all(t.dtype == torch.float32 and t.is_contiguous()
                 for t in (main, cache, delta))
             and cache.shape == delta.shape and Ld == L,
             "sync_round: the pools must be contiguous f32, cache and delta "
             "of one shape, rows of one width")
    _require(len({main.data_ptr(), cache.data_ptr(), delta.data_ptr()}) == 3,
             "sync_round: main, cache and delta must be three pools")
    _require(all(t.dtype == torch.int32 and t.is_contiguous()
                 and t.numel() == n for t in (r_sh, r_cs, o_sh, o_sl)),
             "sync_round: coordinates must be contiguous int32 [n]")
    _require(So * Ro < 2**31 - 1 and S * C < 2**31 - 1,
             "sync_round: a pool has too many rows for int32 targets")
    _require(n <= 2**30, "sync_round: at most 2**30 replicas a round")
    if n == 0:
        return
    stream = torch.cuda.current_stream(main.device)
    words = 2 * So * Ro + S * C + 1
    claims = _claim_scratch("sync_round", main, stream, words)
    entries = _entry_scratch("sync_round", main, stream, 2 * n + 1)
    rc = _lib("sync_round").adapm_sync_round(
        _ptr(main), _ptr(cache), _ptr(delta), _ptr(r_sh), _ptr(r_cs),
        _ptr(o_sh), _ptr(o_sl), n, S, C, So, Ro, L, _ptr(claims),
        _ptr(entries), int(threshold > 0.0), float(threshold),
        int(L % 4 == 0 and _aligned16(main, cache, delta)),
        stream.cuda_stream)
    LAUNCHES["sync_round"] += 1
    if rc != 0:
        # a round that never ran leaves the scratch claimed
        _claims.pop(_claim_key("sync_round", main, stream, words), None)
    _check(rc, "sync_round")


def sync_compress_plain(delta, r_sh, r_cs, mode: str, threshold: float):
    """The plain version of K12 (any device): the wire transform of one
    compressed sync round, tier/quant.py compress_delta in torch ops.
    Divisors are tensors (a division by a Python number may run as a
    multiplication by its reciprocal on the card)."""
    d = _fill_gather_plain(delta, r_sh, r_cs)
    mx = d.abs().amax(dim=1) if d.shape[0] else d.new_zeros(0)
    ship = mx >= torch.full_like(mx, threshold)
    if mode == "fp16":
        shipped = torch.clamp(d, -F16_MAX, F16_MAX).to(torch.float16).to(
            torch.float32)
    else:
        s = torch.clamp(mx / torch.full_like(mx, 127.0), 0.0, F16_MAX).to(
            torch.float16).to(torch.float32)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        q = torch.clamp(torch.round(d / safe[:, None]), -127.0, 127.0)
        shipped = q.to(torch.int8).to(torch.float32) * s[:, None]
    resid = d - shipped
    new_delta = torch.where(ship[:, None], resid, d)
    norm = torch.where(ship[:, None], resid.abs(), torch.zeros_like(resid))
    norm = norm.amax() if norm.numel() else d.new_zeros(())
    return shipped, new_delta, ship, norm


def sync_compress(delta, r_sh, r_cs, mode: str, threshold: float):
    """K12: the wire transform of a compressed sync round over replica
    rows (r_sh, r_cs) of the [S, slots, L] f32 delta pool. Returns
    (shipped [n, L], new delta rows [n, L], ship [n] bool, the max-abs
    parked residual as a 0-dim f32 tensor); see csrc/sync_compress.cu."""
    _require(mode in ("fp16", "int8"),
             f"sync_compress: mode must be 'fp16' or 'int8' (got {mode!r})")
    if not _on_cuda(delta, r_sh, r_cs):
        return sync_compress_plain(delta, r_sh, r_cs, mode, threshold)
    S, R, L = delta.shape
    n = r_sh.numel()
    _require(delta.dtype == torch.float32 and delta.is_contiguous(),
             "sync_compress: the delta pool must be contiguous f32")
    for t in (r_sh, r_cs):
        _require(t.dtype == torch.int32 and t.numel() == n
                 and t.is_contiguous(),
                 "sync_compress: coordinates must be contiguous int32 [n]")
    dev = delta.device
    shipped = torch.empty((n, L), dtype=torch.float32, device=dev)
    new_delta = torch.empty((n, L), dtype=torch.float32, device=dev)
    ship = torch.empty(n, dtype=torch.bool, device=dev)
    bits = torch.zeros(1, dtype=torch.int32, device=dev)
    if n:
        vec = int(L % 4 == 0 and _aligned16(delta, shipped, new_delta))
        rc = _lib("sync_compress").adapm_sync_compress(
            _ptr(delta), _ptr(r_sh), _ptr(r_cs), n, S, R, L,
            float(threshold), _ptr(shipped), _ptr(new_delta), _ptr(ship),
            _ptr(bits), WIRE_MODES[mode], vec, _stream())
        LAUNCHES["sync_compress"] += 1
        _check(rc, "sync_compress")
    return shipped, new_delta, ship, bits.view(torch.float32)[0]


# ---------------------------------------------------------------------------
# K4 pool_eval_counts
# ---------------------------------------------------------------------------


def pool_eval_counts_plain(pool, owner, slot, keys, nvalid: int, q_o, q_s,
                           true_sc, okey, skey, parts: int = 1,
                           ties: bool = False):
    """The plain version of K4, in the JAX program's own formula: per
    chunk (a row of `keys`), gather the candidate rows, score both sides
    as `parts` matmuls over consecutive column blocks of K (ComplEx:
    `a@er.T + b@ei.T`, parts=2; RESCAL: `sR@ent.T`, parts=1), mask the
    padding and the true key, count.

    With `ties=True` it also returns, per query and side, the number of
    eligible candidates that are near-ties: |sc - true_sc| <= 2*g*S with
    S = sum_k |q_k * row_k| and g = K*u / (1 - K*u), u = 2^-24. Any f32
    evaluation of a K-term dot product, in any order, with or without
    FMA, lies within g*S of the exact value, so two evaluations (this
    one and the kernel's, or XLA's) differ by at most 2*g*S, and only a
    near-tie can be counted by one and not the other: a count may
    differ from this one by at most its near-tie count."""
    nch, C = keys.shape
    B, K = q_o.shape
    h = K // parts
    dev = q_o.device
    g_o = torch.zeros(B, dtype=torch.int32, device=dev)
    g_s = torch.zeros_like(g_o)
    t_o = torch.zeros_like(g_o)
    t_s = torch.zeros_like(g_o)
    u = 2.0 ** -24
    gamma = K * u / (1 - K * u)
    for ci in range(nch):
        k = keys[ci]
        kl = k.long()
        rows = _fill_gather_plain(pool, owner.index_select(0, kl),
                                  slot.index_select(0, kl))[:, :K]
        so = sum(q_o[:, p * h:(p + 1) * h] @ rows[:, p * h:(p + 1) * h].T
                 for p in range(parts))
        ss = sum(q_s[:, p * h:(p + 1) * h] @ rows[:, p * h:(p + 1) * h].T
                 for p in range(parts))
        mask = (ci * C + torch.arange(C, device=dev)) < nvalid
        m_o = mask[None, :] & (k[None, :] != okey[:, None])
        m_s = mask[None, :] & (k[None, :] != skey[:, None])
        t = true_sc[:, None]
        g_o += ((so > t) & m_o).sum(1, dtype=torch.int32)
        g_s += ((ss > t) & m_s).sum(1, dtype=torch.int32)
        if ties:
            ra = rows.abs().T
            near_o = (so - t).abs() <= 2 * gamma * (q_o.abs() @ ra)
            near_s = (ss - t).abs() <= 2 * gamma * (q_s.abs() @ ra)
            t_o += (near_o & m_o).sum(1, dtype=torch.int32)
            t_s += (near_s & m_s).sum(1, dtype=torch.int32)
    return (g_o, g_s, t_o, t_s) if ties else (g_o, g_s)


# K4's launch geometry (kCt, kKC, kStages, kSlots in the source)
K4_TILE, K4_CHUNK, K4_STAGES, K4_SLOTS = 128, 64, 2, 8
K4_SMEM_MAX = 232_448            # dynamic shared memory of one H100 CTA
K4_BQ = (64, 48, 32, 16)         # query blocks the kernel is built for


class K4Plan(NamedTuple):
    Bq: int                      # queries per CTA (16 groups x TQ)
    Ct: int                      # candidates per tile
    stages: int                  # chunks in flight in the cp.async ring
    smem_bytes: int
    grid: Tuple[int, int]        # (candidate CTAs, query blocks)
    resident: bool               # query block held for the whole CTA
    vec: bool                    # 16-byte copies (before pointer alignment)


def _k4_smem(Bq: int, K: int, resident: bool) -> int:
    """Dynamic shared memory of one K4 CTA (smem_need in the source):
    the pointer and key tables, the candidate ring, and the query block
    (all of K when resident, else one chunk per ring stage)."""
    kp = -(-K // K4_CHUNK) * K4_CHUNK
    q = 2 * kp * Bq if resident else K4_STAGES * 2 * K4_CHUNK * Bq
    return K4_SLOTS * K4_TILE * 12 + \
        (K4_STAGES * K4_TILE * (K4_CHUNK + 4) + q) * 4


def _k4_plan(B: int, K: int, L: int, nvalid: int, sms: int) -> K4Plan:
    """K4's launch plan for B queries of width K over `nvalid` candidates
    on a card of `sms` SMs. The query block Bq is the one of K4_BQ whose
    resident copy fits in shared memory and that costs least, counting
    per candidate the query blocks times (Bq + 16) (the 16 stands for a
    block's candidate copies and per-tile overhead; a tie takes the
    larger Bq): B=64 takes 64, B=36 48, and a wider K fits only smaller
    blocks. Where no block fits resident, queries stream through the
    ring with the candidates. The grid holds about one CTA per SM:
    ceil(B/Bq) query blocks times as many candidate CTAs as SMs remain
    for each, none without a tile, the tiles spread evenly."""
    best = None
    for resident in (True, False):
        for bq in K4_BQ:
            smem = _k4_smem(bq, K, resident)
            if smem > K4_SMEM_MAX:
                continue
            nqb = -(-B // bq)
            cost = nqb * (bq + 16)
            if best is None or cost < best[0]:
                best = (cost, bq, smem)
        if best is not None:
            break
    _, bq, smem = best
    nqb = -(-B // bq)
    ntiles = max(1, -(-nvalid // K4_TILE))
    gx = max(1, min(ntiles, sms // nqb))
    gx = -(-ntiles // -(-ntiles // gx))        # same rounds, fewer CTAs
    return K4Plan(Bq=bq, Ct=K4_TILE, stages=K4_STAGES, smem_bytes=smem,
                  grid=(gx, nqb), resident=resident,
                  vec=L % 4 == 0 and K % 4 == 0)


_sm_count: Dict[int, int] = {}


def _sms(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _sm_count:
        _sm_count[i] = torch.cuda.get_device_properties(i) \
            .multi_processor_count
    return _sm_count[i]


def pool_eval_counts(pool: torch.Tensor, owner: torch.Tensor,
                     slot: torch.Tensor, keys: torch.Tensor, nvalid: int,
                     q_o: torch.Tensor, q_s: torch.Tensor,
                     true_sc: torch.Tensor, okey: torch.Tensor,
                     skey: torch.Tensor, parts: int = 1):
    """Per query b, the number of real candidates (the first `nvalid`
    entries of the padded [nch, C] int32 key table `keys`) whose row
    pool[owner[key], slot[key], :K] scores strictly above true_sc[b],
    the true key (okey[b] for the object side, skey[b] for the subject
    side) excluded by key. q_o/q_s are the [B, K] f32 query coefficients;
    `parts` only shapes the plain version's matmuls. Returns (g_o, g_s),
    new int32 [B] tensors."""
    if not _on_cuda(pool, owner, slot, keys, q_o, q_s, true_sc, okey, skey):
        return pool_eval_counts_plain(pool, owner, slot, keys, nvalid, q_o,
                                      q_s, true_sc, okey, skey, parts)
    S, R, L = pool.shape
    B, K = q_o.shape
    _require(pool.dtype == torch.float32 and pool.is_contiguous(),
             "pool_eval_counts: pool must be contiguous f32 [S, slots, L]")
    _require(0 < K <= L, "pool_eval_counts: K must lie in (0, L]")
    for t in (q_o, q_s):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and tuple(t.shape) == (B, K),
                 "pool_eval_counts: q_o/q_s must be contiguous f32 [B, K]")
    _require(true_sc.dtype == torch.float32 and true_sc.is_contiguous()
             and true_sc.numel() == B,
             "pool_eval_counts: true_sc must be contiguous f32 [B]")
    for t in (owner, slot, keys, okey, skey):
        _require(t.dtype == torch.int32 and t.is_contiguous(),
                 "pool_eval_counts: tables and keys must be contiguous "
                 "int32")
    _require(owner.numel() == slot.numel() and okey.numel() == B
             and skey.numel() == B and keys.dim() == 2,
             "pool_eval_counts: shape mismatch")
    _require(0 <= nvalid <= keys.numel(),
             "pool_eval_counts: nvalid exceeds the key table")
    g_o, g_s = torch.zeros((2, B), dtype=torch.int32, device=pool.device)
    if nvalid == 0 or B == 0:
        return g_o, g_s
    plan = _k4_plan(B, K, L, int(nvalid), _sms(pool.device))
    vec = int(plan.vec and _aligned16(pool, q_o, q_s))
    rc = _lib("pool_eval_counts").adapm_pool_eval_counts(
        _ptr(pool), S, R, L, K, _ptr(owner), _ptr(slot), owner.numel(),
        _ptr(keys), int(nvalid), _ptr(q_o), _ptr(q_s), _ptr(true_sc),
        _ptr(okey), _ptr(skey), B, vec, plan.Bq, plan.stages,
        plan.smem_bytes, *plan.grid, int(plan.resident), _ptr(g_o),
        _ptr(g_s), _stream())
    LAUNCHES["pool_eval_counts"] += 1
    _check(rc, "pool_eval_counts")
    return g_o, g_s


# ---------------------------------------------------------------------------
# K5-K7, K16: the model math of a fused step (shared checks and plain
# emission)
# ---------------------------------------------------------------------------


def _emit_plain(rows, grads, roles, lr_eps, out, grad_out) -> None:
    """Write each role's gradient into `grad_out` and its AdaGrad delta
    rows (K2's plain rule on the role's accumulator half) into `out`."""
    lr, eps = (float(v) for v in lr_eps.tolist())
    for k in roles:
        D = rows[k].shape[-1] // 2
        g = grads[k].reshape(-1, D)
        if grad_out.get(k) is not None:
            grad_out[k].copy_(g)
        if out.get(k) is not None:
            acc = rows[k].reshape(-1, 2 * D)[:, D:]
            out[k].copy_(adagrad_update_plain(g, acc, lr, eps))


def _check_outs(what, nrows, width, out, grad_out):
    """`width`: the embedding width, or a dict of it per role."""
    for outs, f in ((out, 2), (grad_out, 1)):
        for k, t in outs.items():
            wd = f * (width.get(k, 0) if isinstance(width, dict) else width)
            _require(k in nrows and tuple(t.shape) == (nrows[k], wd)
                     and t.dtype == torch.float32 and t.is_contiguous(),
                     f"{what}: output {k!r} must be contiguous f32 "
                     f"[{nrows.get(k)}, {wd}]")


def _check_rows(what, ins, lr_eps):
    for t in ins:
        _require(t.dtype == torch.float32 and t.stride(-1) == 1,
                 f"{what}: rows must be f32 with contiguous rows")
    _require(lr_eps.dtype == torch.float32 and lr_eps.numel() == 2
             and lr_eps.is_contiguous(),
             f"{what}: lr_eps must be a contiguous f32 [2]")


def _role_args(roles, ins, out, grad_out):
    args = []
    for k, t in zip(roles, ins):
        args += [_ptr(t), t.stride(0), _ptr(out.get(k)),
                 _ptr(grad_out.get(k))]
    return args


def _vec(d, ins, *outs) -> int:
    """The 16-byte path: d % 4 == 0 and every row 16-byte aligned."""
    return int(d % 4 == 0 and all(t.stride(0) % 4 == 0 for t in ins)
               and _aligned16(*ins, *outs))


# ---------------------------------------------------------------------------
# K5 complex_step
# ---------------------------------------------------------------------------

COMPLEX_ROLES = ("s", "r", "o", "neg")


def _lae_grad(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """g times the derivative of logaddexp(x, 0), as autograd forms it:
    g / (1 + exp(0 - x))."""
    return g / (1 + torch.exp(torch.zeros_like(x) - x))


def _complex_grads(s, r, o, neg, self_adv_temp: float, l2: float):
    """The ComplEx loss's per-triple values and its gradient per role, in
    closed form over the embedding halves s, r, o [B, 2d] and neg
    [B, N, 2d]. The terms are grouped as PyTorch's autograd groups them
    for models/kge.py KgeLoss (every product, sum and reduction in the
    same association), so on the CPU this is bitwise the autograd
    gradient; the kernel groups them as NS/NO sums (csrc/complex_step.cu)
    and agrees within the f32 model-math tolerance."""
    B = s.shape[0]
    d = s.shape[-1] // 2
    sr, si, rr, ri, orr, oi = (x[..., h] for x in (s, r, o)
                               for h in (slice(None, d), slice(d, None)))
    nr, ni = neg[..., :d], neg[..., d:]
    sru, siu, rru, riu, oru, oiu = (x[:, None] for x in
                                    (sr, si, rr, ri, orr, oi))
    p1, p2, p3, p4 = sr * rr, si * rr, sr * ri, si * ri        # pos
    pos = (p1 * orr + p2 * oi + p3 * oi - p4 * orr).sum(-1)
    q1, q2, q3, q4 = nr * rru, ni * rru, nr * riu, ni * riu   # neg as s
    ns = (q1 * oru + q2 * oiu + q3 * oiu - q4 * oru).sum(-1)
    m1, m2, m3, m4 = sru * rru, siu * rru, sru * riu, siu * riu  # neg as o
    no = (m1 * nr + m2 * ni + m3 * ni - m4 * nr).sum(-1)

    def softplus(x):
        return torch.logaddexp(x, torch.zeros_like(x))

    g0 = s.new_ones(()).expand(B) / B          # d mean / d loss_b
    g0n = g0[:, None].expand(ns.shape)
    if self_adv_temp > 0.0:
        ws = torch.softmax(self_adv_temp * ns, dim=-1)
        wo = torch.softmax(self_adv_temp * no, dim=-1)
        nll = softplus(-pos) + ((ws * softplus(ns)).sum(-1)
                                + (wo * softplus(no)).sum(-1))
        gs, go = _lae_grad(g0n * ws, ns), _lae_grad(g0n * wo, no)
    else:
        nll = softplus(-pos) + (softplus(ns).sum(-1) + softplus(no).sum(-1))
        gs, go = _lae_grad(g0n, ns), _lae_grad(g0n, no)
    gp = -_lae_grad(g0, -pos)
    gp, gs, go = gp[:, None], gs[..., None], go[..., None]

    def cat(a, b):
        return torch.cat([a, b], -1)

    def S(x):                                   # sum over the negatives
        return x.sum(1)

    # s: the positive score, then the object-side corruptions
    s_pos = cat((gp * orr) * rr + (gp * oi) * ri,
                (gp * oi) * rr + ((-gp) * orr) * ri)
    s_neg = cat(S(go * nr) * rr + S(go * ni) * ri,
                S(go * ni) * rr + S((-go) * nr) * ri)
    # o: the positive score, then the subject-side corruptions
    o_pos = cat(gp * p1 + (-gp) * p4, gp * p2 + gp * p3)
    o_neg = cat(S(gs * q1) + S((-gs) * q4), S(gs * q2) + S(gs * q3))
    # r: positive, subject side, object side
    r_pos = cat((gp * orr) * sr + (gp * oi) * si,
                (gp * oi) * sr + ((-gp) * orr) * si)
    r_ns = cat(S((gs * oru) * nr) + S((gs * oiu) * ni),
               S((gs * oiu) * nr) + S(((-gs) * oru) * ni))
    r_no = cat(S(go * nr) * sr + S(go * ni) * si,
               S(go * ni) * sr + S((-go) * nr) * si)
    g_neg = cat((gs * oru) * rru + (gs * oiu) * riu,
                (gs * oiu) * rru + ((-gs) * oru) * riu) \
        + cat(go * m1 + (-go) * m4, go * m2 + go * m3)
    if l2 > 0.0:
        gl = (s.new_ones(()) * l2).expand(B)[:, None] / B
        grads = {"s": (2 * (gl * s) + s_neg) + s_pos,
                 "o": (2 * (gl * o) + o_neg) + o_pos,
                 "r": ((2 * (gl * r) + r_no) + r_ns) + r_pos,
                 "neg": g_neg}
        sq = (s * s).sum(-1) + (r * r).sum(-1) + (o * o).sum(-1)
        return nll + l2 * sq, grads
    grads = {"s": s_neg + s_pos, "o": o_neg + o_pos,
             "r": (r_no + r_ns) + r_pos, "neg": g_neg}
    return nll, grads


def complex_step_plain(s, r, o, neg, lr_eps: torch.Tensor,
                       self_adv_temp: float = 0.0, l2: float = 0.0,
                       out=None, grad_out=None) -> torch.Tensor:
    """The plain version of K5 (any device): the closed-form loss and
    gradient (`_complex_grads`), then K2's plain update rule per role in
    `out`. Arguments and result as complex_step."""
    D = s.shape[-1] // 2
    rows = {"s": s, "r": r, "o": o, "neg": neg}
    loss, grads = _complex_grads(*(rows[k][..., :D] for k in COMPLEX_ROLES),
                                 float(self_adv_temp), float(l2))
    _emit_plain(rows, grads, COMPLEX_ROLES, lr_eps, out or {},
                grad_out or {})
    return loss


def complex_step(s: torch.Tensor, r: torch.Tensor, o: torch.Tensor,
                 neg: torch.Tensor, lr_eps: torch.Tensor,
                 self_adv_temp: float = 0.0, l2: float = 0.0,
                 out: Optional[Dict[str, torch.Tensor]] = None,
                 grad_out: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """The ComplEx step's model math in one launch: s, r, o [B, 4d] and
    neg [B, N, 4d] are gathered rows [emb 2d | acc 2d] (views of K1's
    buffer: only the last dim must be contiguous); lr_eps is a 2-float
    device tensor (lr, eps), read by the kernel, so a captured graph
    follows it. For each role in `out` (a contiguous f32 [rows, 4d], e.g.
    a row slice of the step's update buffer) writes the AdaGrad delta
    rows [-lr*g*rsqrt(acc + g^2 + eps) | g^2] (K2's arithmetic); roles
    missing from `out` are frozen: read, never written. `grad_out`
    optionally takes each role's raw gradient [rows, 2d]. Returns the
    [B] per-triple loss (the batch loss is its sum over B)."""
    out = {k: v for k, v in (out or {}).items() if v is not None}
    grad_out = {k: v for k, v in (grad_out or {}).items() if v is not None}
    _require(s.dim() == 2 and r.shape == s.shape and o.shape == s.shape
             and neg.dim() == 3 and neg.shape[0] == s.shape[0]
             and neg.shape[2] == s.shape[1] and s.shape[1] % 4 == 0,
             "complex_step: s, r, o must be [B, 4d] and neg [B, N, 4d]")
    B, L = s.shape
    N, d = neg.shape[1], L // 4
    _check_outs("complex_step", {"s": B, "r": B, "o": B, "neg": B * N},
                L // 2, out, grad_out)
    _require(self_adv_temp >= 0.0, "complex_step: self_adv_temp < 0")
    if not _on_cuda(s, r, o, neg, lr_eps, *out.values(),
                    *grad_out.values()):
        return complex_step_plain(s, r, o, neg, lr_eps, self_adv_temp, l2,
                                  out, grad_out)
    ins = (s, r, o, neg.reshape(B * N, L))
    _check_rows("complex_step", ins, lr_eps)
    lib = _lib("complex_step")
    smem = lib.adapm_complex_step_smem(N, d)
    _require(smem <= K4_SMEM_MAX,
             f"complex_step: N={N}, d={d} needs {smem} bytes of shared "
             f"memory, more than one CTA has ({K4_SMEM_MAX})")
    loss = torch.empty(B, dtype=torch.float32, device=s.device)
    if B == 0:
        return loss
    rc = lib.adapm_complex_step(
        *_role_args(COMPLEX_ROLES, ins, out, grad_out), _ptr(loss),
        _ptr(lr_eps), B, N, d, float(self_adv_temp), float(l2),
        _vec(d, ins, *out.values(), *grad_out.values()), _stream())
    LAUNCHES["complex_step"] += 1
    _check(rc, "complex_step")
    return loss


# ---------------------------------------------------------------------------
# K16 rescal_step
# ---------------------------------------------------------------------------

RESCAL_ROLES = ("s", "r", "o", "neg")


def _rescal_grads(s, r, o, neg, self_adv_temp: float, l2: float):
    """The RESCAL loss's per-triple values and its gradient per role, in
    closed form over the embedding halves s, o [B, d], r [B, d^2] (R =
    r.reshape(d, d), row-major) and neg [B, N, d]: u = R o, v = R^T s,
    pos = s.u, ns = n.u, no = v.n; with the loss's coefficients dpos,
    dns, dno and x = sum_k dns_k n_k, y = sum_k dno_k n_k the gradients
    are g_s = dpos u + R y, g_o = dpos v + R^T x, g_n = dns u + dno v and
    g_R = (dpos s + x) o^T + s y^T (csrc/rescal_step.cu's header). Sums
    run in another order than autograd's over the score's einsum, so
    this agrees with it within the f32 model-math tolerance."""
    B, d = s.shape
    R = r.reshape(B, d, d)
    u = (R * o[:, None, :]).sum(-1)
    v = (R * s[:, :, None]).sum(1)
    pos = (s * u).sum(-1)
    ns = (neg * u[:, None, :]).sum(-1)
    no = (neg * v[:, None, :]).sum(-1)
    if self_adv_temp > 0.0:
        ws = torch.softmax(self_adv_temp * ns, dim=-1)
        wo = torch.softmax(self_adv_temp * no, dim=-1)
    else:
        ws = wo = torch.ones_like(ns)
    loss = _softplus(-pos) + ((ws * _softplus(ns)).sum(-1)
                              + (wo * _softplus(no)).sum(-1))
    dpos = (-torch.sigmoid(-pos) / B)[:, None]
    dns = (ws * torch.sigmoid(ns) / B)[..., None]
    dno = (wo * torch.sigmoid(no) / B)[..., None]
    x = (dns * neg).sum(1)
    y = (dno * neg).sum(1)
    a = dpos * s + x
    grads = {"s": dpos * u + (R * y[:, None, :]).sum(-1),
             "o": dpos * v + (R * x[:, :, None]).sum(1),
             "neg": dns * u[:, None, :] + dno * v[:, None, :],
             "r": (a[:, :, None] * o[:, None, :]
                   + s[:, :, None] * y[:, None, :]).reshape(B, d * d)}
    if l2 > 0.0:
        c2 = 2.0 * l2 / B
        for k, t in (("s", s), ("r", r), ("o", o)):
            grads[k] = grads[k] + c2 * t
        loss = loss + l2 * ((s * s).sum(-1) + (r * r).sum(-1)
                            + (o * o).sum(-1))
    return loss, grads


def rescal_step_plain(s, r, o, neg, lr_eps: torch.Tensor,
                      self_adv_temp: float = 0.0, l2: float = 0.0,
                      out=None, grad_out=None) -> torch.Tensor:
    """The plain version of K16 (any device): the closed-form loss and
    gradient (`_rescal_grads`), then K2's plain update rule per role in
    `out`. Arguments and result as rescal_step."""
    d = s.shape[-1] // 2
    loss, grads = _rescal_grads(s[..., :d], r[..., :d * d], o[..., :d],
                                neg[..., :d], float(self_adv_temp),
                                float(l2))
    _emit_plain({"s": s, "r": r, "o": o, "neg": neg}, grads, RESCAL_ROLES,
                lr_eps, out or {}, grad_out or {})
    return loss


def rescal_step(s: torch.Tensor, r: torch.Tensor, o: torch.Tensor,
                neg: torch.Tensor, lr_eps: torch.Tensor,
                self_adv_temp: float = 0.0, l2: float = 0.0,
                out: Optional[Dict[str, torch.Tensor]] = None,
                grad_out: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """The RESCAL step's model math in one launch: s, o [B, 2d], r
    [B, 2d^2] and neg [B, N, 2d] are gathered rows [emb | acc] (views of
    K1's buffers: only the last dim must be contiguous); lr_eps is a
    2-float device tensor (lr, eps), read by the kernel, so a captured
    graph follows it. For each role in `out` (a contiguous f32 [rows,
    2 * emb], e.g. a row slice of the step's update buffer) writes the
    AdaGrad delta rows [-lr*g*rsqrt(acc + g^2 + eps) | g^2] (K2's
    arithmetic); roles missing from `out` are frozen: read, never
    written. `grad_out` optionally takes each role's raw gradient [rows,
    emb]. Returns the [B] per-triple loss (the batch loss is its mean).
    The kernel takes no scratch, so under a CUDA graph capture the call
    allocates only that loss (from the graph's pool, as K5's does). A
    (N, d) whose CTA needs more shared memory than one has raises."""
    out = {k: v for k, v in (out or {}).items() if v is not None}
    grad_out = {k: v for k, v in (grad_out or {}).items() if v is not None}
    _require(s.dim() == 2 and s.shape[1] % 2 == 0 and o.shape == s.shape
             and neg.dim() == 3 and neg.shape[0] == s.shape[0]
             and neg.shape[2] == s.shape[1] and r.dim() == 2
             and r.shape[0] == s.shape[0]
             and r.shape[1] == 2 * (s.shape[1] // 2) ** 2,
             "rescal_step: s, o must be [B, 2d], r [B, 2d^2] and neg "
             "[B, N, 2d]")
    B, L = s.shape
    N, d = neg.shape[1], L // 2
    _check_outs("rescal_step", {"s": B, "r": B, "o": B, "neg": B * N},
                {"s": d, "r": d * d, "o": d, "neg": d}, out, grad_out)
    _require(self_adv_temp >= 0.0, "rescal_step: self_adv_temp < 0")
    if not _on_cuda(s, r, o, neg, lr_eps, *out.values(),
                    *grad_out.values()):
        return rescal_step_plain(s, r, o, neg, lr_eps, self_adv_temp, l2,
                                 out, grad_out)
    ins = (s, r, o, neg.reshape(B * N, L))
    _check_rows("rescal_step", ins, lr_eps)
    lib = _lib("rescal_step")
    smem = lib.adapm_rescal_step_smem(N, d)
    _require(smem <= K4_SMEM_MAX,
             f"rescal_step: N={N}, d={d} needs {smem} bytes of shared "
             f"memory, more than one CTA has ({K4_SMEM_MAX})")
    loss = torch.empty(B, dtype=torch.float32, device=s.device)
    if B == 0:
        return loss
    rc = lib.adapm_rescal_step(
        *_role_args(RESCAL_ROLES, ins, out, grad_out), _ptr(loss),
        _ptr(lr_eps), B, N, d, float(self_adv_temp), float(l2),
        _vec(d, ins, *out.values(), *grad_out.values()), _stream())
    LAUNCHES["rescal_step"] += 1
    _check(rc, "rescal_step")
    return loss


# ---------------------------------------------------------------------------
# K6 sgns_step and K7 mf_step
# ---------------------------------------------------------------------------

SGNS_ROLES = ("center", "ctx", "neg")
MF_ROLES = ("w", "h")
# warps (pairs or ratings) per CTA of K6 and K7 (kWarps in the sources)
K67_WARPS = 8
_SMEM_STATIC = 48 * 1024


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as logaddexp(x, 0), the loss modules' softplus."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _sgns_grads(c, x, neg):
    """The SGNS loss's per-pair values and its gradient per role in
    closed form over the embedding halves c, x [B, d] and neg [B, N, d],
    grouped as PyTorch's autograd groups models/sgns.py SgnsLoss (the
    mean's 1/B, logaddexp's derivative, the broadcast's sum over the
    negatives), so on the CPU this is bitwise the autograd gradient."""
    B = c.shape[0]
    pos = (c * x).sum(-1)
    negs = (c[:, None, :] * neg).sum(-1)
    loss = _softplus(-pos) + _softplus(negs).sum(-1)
    g0 = c.new_ones(()).expand(B) / B          # d mean / d loss_b
    gp = (-_lae_grad(g0, -pos))[:, None]
    gn = _lae_grad(g0[:, None].expand(negs.shape), negs)[..., None]
    return loss, {"center": gp * x + (gn * neg).sum(1), "ctx": gp * c,
                  "neg": gn * c[:, None, :]}


def _mf_grads(w, h, x, l2: float):
    """The MF loss's per-rating values e^2 + l2 (|w|^2 + |h|^2), e = w.h -
    x, and its gradient per role, grouped as autograd groups models/mf.py
    MfLoss (the mean's 1/B, pow's 2e, each squared norm's two products
    summed before the residual's term), so on the CPU this is bitwise
    the autograd gradient."""
    B = w.shape[0]
    e = (w * h).sum(-1) - x
    loss = e ** 2 + l2 * ((w * w).sum(-1) + (h * h).sum(-1))
    g0 = w.new_ones(()).expand(B) / B
    ge = (g0 * (2.0 * e))[:, None]
    gr = (g0 * l2)[:, None]
    return loss, {"w": ge * h + (gr * w + gr * w),
                  "h": ge * w + (gr * h + gr * h)}


def sgns_step_plain(center, ctx, neg, lr_eps: torch.Tensor, out=None,
                    grad_out=None) -> torch.Tensor:
    """The plain version of K6 (any device): the closed-form loss and
    gradient (`_sgns_grads`), then K2's plain update rule per role in
    `out`. Arguments and result as sgns_step."""
    out, grad_out = out or {}, grad_out or {}
    d = center.shape[-1] // 2
    rows = {"center": center, "ctx": ctx, "neg": neg}
    loss, grads = _sgns_grads(center[..., :d], ctx[..., :d], neg[..., :d])
    _emit_plain(rows, grads, SGNS_ROLES, lr_eps, out, grad_out)
    return loss


def sgns_step(center: torch.Tensor, ctx: torch.Tensor, neg: torch.Tensor,
              lr_eps: torch.Tensor,
              out: Optional[Dict[str, torch.Tensor]] = None,
              grad_out: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
    """The SGNS step's model math in one launch: center, ctx [B, 2d] and
    neg [B, N, 2d] are gathered rows [emb d | acc d] (views of K1's
    buffer: only the last dim must be contiguous); lr_eps is (lr, eps) as
    a 2-float tensor on their device, read by the kernel. For each role
    in `out` (a contiguous f32 [rows, 2d]) writes the AdaGrad delta rows
    [-lr*g*rsqrt(acc + g^2 + eps) | g^2]; roles missing from `out` are
    frozen. `grad_out` optionally takes each role's gradient [rows, d].
    Returns the [B] per-pair loss softplus(-c.x) + sum_n softplus(c.n_n)
    (the batch loss is its mean)."""
    out = {k: v for k, v in (out or {}).items() if v is not None}
    grad_out = {k: v for k, v in (grad_out or {}).items() if v is not None}
    _require(center.dim() == 2 and ctx.shape == center.shape
             and neg.dim() == 3 and neg.shape[0] == center.shape[0]
             and neg.shape[2] == center.shape[1]
             and center.shape[1] % 2 == 0,
             "sgns_step: center, ctx must be [B, 2d] and neg [B, N, 2d]")
    B, L = center.shape
    N, d = neg.shape[1], L // 2
    _check_outs("sgns_step", {"center": B, "ctx": B, "neg": B * N}, d,
                out, grad_out)
    if not _on_cuda(center, ctx, neg, lr_eps, *out.values(),
                    *grad_out.values()):
        return sgns_step_plain(center, ctx, neg, lr_eps, out, grad_out)
    ins = (center, ctx, neg.reshape(B * N, L))
    _check_rows("sgns_step", ins, lr_eps)
    _require(K67_WARPS * (N + 1) * 4 <= _SMEM_STATIC,
             f"sgns_step: N={N} negatives exceed the kernel's shared "
             "memory")
    loss = torch.empty(B, dtype=torch.float32, device=center.device)
    if B == 0:
        return loss
    rc = _lib("sgns_step").adapm_sgns_step(
        *_role_args(SGNS_ROLES, ins, out, grad_out), _ptr(loss),
        _ptr(lr_eps), B, N, d,
        _vec(d, ins, *out.values(), *grad_out.values()), _stream())
    LAUNCHES["sgns_step"] += 1
    _check(rc, "sgns_step")
    return loss


def mf_step_plain(w, h, x, lr_eps: torch.Tensor, l2: float = 0.0,
                  out=None, grad_out=None) -> torch.Tensor:
    """The plain version of K7 (any device): the closed-form loss and
    gradient (`_mf_grads`), then K2's plain update rule per role in
    `out`. Arguments and result as mf_step."""
    out, grad_out = out or {}, grad_out or {}
    r = w.shape[-1] // 2
    loss, grads = _mf_grads(w[..., :r], h[..., :r], x, float(l2))
    _emit_plain({"w": w, "h": h}, grads, MF_ROLES, lr_eps, out, grad_out)
    return loss


def mf_step(w: torch.Tensor, h: torch.Tensor, x: torch.Tensor,
            lr_eps: torch.Tensor, l2: float = 0.0,
            out: Optional[Dict[str, torch.Tensor]] = None,
            grad_out: Optional[Dict[str, torch.Tensor]] = None
            ) -> torch.Tensor:
    """The MF step's model math in one launch: w, h [B, 2r] are gathered
    rows [factor r | acc r] (views of K1's buffer) and x the [B] f32
    ratings; lr_eps as in sgns_step. Writes the AdaGrad delta rows of
    each role in `out` (roles missing are frozen) and optionally each
    role's gradient into `grad_out` [B, r]. Returns the [B] per-rating
    loss (w.h - x)^2 + l2 (|w|^2 + |h|^2) (the batch loss is its mean)."""
    out = {k: v for k, v in (out or {}).items() if v is not None}
    grad_out = {k: v for k, v in (grad_out or {}).items() if v is not None}
    _require(w.dim() == 2 and h.shape == w.shape and w.shape[1] % 2 == 0
             and x.dim() == 1 and x.shape[0] == w.shape[0],
             "mf_step: w, h must be [B, 2r] and x [B]")
    B, L = w.shape
    r = L // 2
    _check_outs("mf_step", {"w": B, "h": B}, r, out, grad_out)
    if not _on_cuda(w, h, x, lr_eps, *out.values(), *grad_out.values()):
        return mf_step_plain(w, h, x, lr_eps, l2, out, grad_out)
    _check_rows("mf_step", (w, h), lr_eps)
    _require(x.dtype == torch.float32 and x.is_contiguous(),
             "mf_step: ratings must be contiguous f32 [B]")
    loss = torch.empty(B, dtype=torch.float32, device=w.device)
    if B == 0:
        return loss
    rc = _lib("mf_step").adapm_mf_step(
        *_role_args(MF_ROLES, (w, h), out, grad_out), _ptr(x), _ptr(loss),
        _ptr(lr_eps), B, r, float(l2),
        _vec(r, (w, h), *out.values(), *grad_out.values()), _stream())
    LAUNCHES["mf_step"] += 1
    _check(rc, "mf_step")
    return loss


# ---------------------------------------------------------------------------
# K13 alltoall_put
# ---------------------------------------------------------------------------


def alltoall_put_plain(src: torch.Tensor, dsts, offset: int) -> None:
    """The plain version of K13: row d of `src` [P, T] (uint8) copied to
    `dsts[d][offset:offset + T]`, every d, with `copy_`."""
    T = src.shape[1]
    for d, dst in enumerate(dsts):
        dst[offset:offset + T].copy_(src[d])


def alltoall_put(src: torch.Tensor, dsts, offset: int,
                 table: Optional[torch.Tensor] = None) -> None:
    """K13: one launch writes row d of `src` [P, T] (contiguous uint8)
    into `dsts[d]` (a flat uint8 tensor: a receive slab, this process's
    own or a peer's mapped through CUDA IPC) at byte `offset`, for every
    destination d. `table` is the [P] int64 device array of the slabs'
    base pointers (each `dsts[d].data_ptr()`) on `src`'s card, built
    here when None; with a table, a peer's slab may lie on another card
    (the launch writes it through peer access). T and `offset` must be
    multiples of 16. CPU tensors take the plain version."""
    P = len(dsts)
    _require(src.dim() == 2 and src.shape[0] == P and
             src.dtype == torch.uint8 and src.is_contiguous(),
             "alltoall_put: src must be a contiguous uint8 [P, T]")
    T = src.shape[1]
    for dst in dsts:
        _require(dst.dtype == torch.uint8 and dst.dim() == 1 and
                 offset >= 0 and offset + T <= dst.numel(),
                 "alltoall_put: each destination must be a flat uint8 slab "
                 "holding [offset, offset + T)")
    if not _on_cuda(src, *(dsts if table is None else [table])):
        alltoall_put_plain(src, dsts, offset)
        return
    _require(T % 16 == 0 and offset % 16 == 0 and _aligned16(src, *dsts),
             "alltoall_put: T, offset and every buffer must be 16-byte "
             "aligned")
    if table is None:
        table = torch.tensor([d.data_ptr() for d in dsts],
                             dtype=torch.int64, device=src.device)
    _require(table.dtype == torch.int64 and table.numel() == P and
             table.device == src.device,
             "alltoall_put: table must be the [P] int64 device pointers")
    rc = _lib("alltoall_put").adapm_alltoall_put(
        _ptr(src), _ptr(table), P, T, int(offset), _stream())
    LAUNCHES["alltoall_put"] += 1
    _check(rc, "alltoall_put")


class _SlabView:
    """`__cuda_array_interface__` of a raw device allocation, so torch
    can view it without owning it."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (int(nbytes),), "typestr": "|u1",
            "data": (int(ptr), False), "strides": None, "version": 2}


def slab_view(ptr: int, nbytes: int) -> torch.Tensor:
    """A flat uint8 tensor over `nbytes` of device memory at `ptr` (a
    slab from `slab_alloc` or `slab_open`), on the card that holds it;
    it does not own the memory."""
    return torch.as_tensor(_SlabView(ptr, nbytes))


def _a2a_call(fn, what: str, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{what} failed (cudaError {rc})")


def slab_alloc(nbytes: int) -> Tuple[int, bytes]:
    """A zeroed receive slab from raw cudaMalloc on the current device:
    (pointer, its 64-byte CUDA IPC handle)."""
    lib = _lib("alltoall_put")
    ptr = ctypes.c_void_p()
    handle = ctypes.create_string_buffer(64)
    _a2a_call(lib.adapm_a2a_alloc, "cudaMalloc/cudaIpcGetMemHandle",
              int(nbytes), ctypes.byref(ptr), handle)
    return int(ptr.value), handle.raw


def slab_open(handle: bytes) -> int:
    """Map a peer's slab (cudaIpcOpenMemHandle, lazy peer access);
    raises if the handle cannot be opened."""
    lib = _lib("alltoall_put")
    ptr = ctypes.c_void_p()
    _a2a_call(lib.adapm_a2a_open, "cudaIpcOpenMemHandle",
              ctypes.c_char_p(bytes(handle)), ctypes.byref(ptr))
    return int(ptr.value)


def slab_close(ptr: int) -> None:
    """Unmap a peer's slab (cudaIpcCloseMemHandle)."""
    _a2a_call(_lib("alltoall_put").adapm_a2a_close, "cudaIpcCloseMemHandle",
              ctypes.c_void_p(ptr))


def slab_free(ptr: int) -> None:
    """Free this process's own slab (cudaFree)."""
    _a2a_call(_lib("alltoall_put").adapm_a2a_free, "cudaFree",
              ctypes.c_void_p(ptr))
