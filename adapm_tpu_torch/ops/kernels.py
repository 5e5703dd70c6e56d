"""The hand-written CUDA kernels of the port, each beside its plain
PyTorch version.

    K1 routed_gather        csrc/routed_gather.cu   (TPU: pallas_kernels.gather_rows)
    K2 adagrad_update /     csrc/adagrad.cu         (TPU: pallas_kernels.adagrad_apply)
       adagrad_apply
    K3 ordered_scatter_add  csrc/ordered_scatter.cu (XLA: jaxport._scatter_add)
    K4 pool_eval_counts     csrc/pool_eval_counts.cu (XLA: models/kge.py
                                                     make_pool_eval_counts)

Every wrapper takes CUDA tensors to its kernel and CPU tensors to its
plain version; there is no fallback between the two. A wrapper checks
device, dtype, shape and contiguity, launches on the current stream,
adds one to `LAUNCHES[name]` per launch, and raises if the launch
failed. The kernels are compiled at first use with `nvcc` for sm_90a
(one process per source, all started together) into shared libraries
with a plain C interface under `build/kernels/`, and loaded with ctypes.
`build()` compiles them up front and returns the seconds it took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SOURCES = {"routed_gather": "routed_gather.cu",
            "adagrad": "adagrad.cu",
            "ordered_scatter": "ordered_scatter.cu",
            "pool_eval_counts": "pool_eval_counts.cu"}

# launches per kernel since the last reset_launches() (chip_smoke.py
# reads them to show the main path went through the kernels)
LAUNCHES: Dict[str, int] = {"routed_gather": 0, "adagrad_update": 0,
                            "ordered_scatter_add": 0, "pool_eval_counts": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
        for name, src in todo.items():
            path = os.path.join(_CSRC, src)
            with open(path, "rb") as f:
                tag = hashlib.sha256(f.read()).hexdigest()[:16]
            out = os.path.join(_build_dir(), f"lib{name}_{tag}.so")
            outs[name] = out
            if os.path.exists(out):
                continue
            tmp = f"{out}.tmp{os.getpid()}"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, path]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
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
        lib.adapm_routed_gather.argtypes = [P] * 9 + [LL] + [I] * 6 + [P]
    elif name == "adagrad":
        lib.adapm_adagrad_update.restype = I
        lib.adapm_adagrad_update.argtypes = [P, P, LL, P, LL, I, F, F, I, P]
        lib.adapm_adagrad_apply.restype = I
        lib.adapm_adagrad_apply.argtypes = [P] * 5 + [LL, F, F, P]
    elif name == "ordered_scatter":
        lib.adapm_ordered_scatter_add.restype = I
        lib.adapm_ordered_scatter_add.argtypes = [P] * 4 + [LL, LL, I, I, P]
    else:
        lib.adapm_pool_eval_counts.restype = I
        lib.adapm_pool_eval_counts.argtypes = [P, I, I, I, I, P, P, LL, P, LL,
                                               P, P, P, P, P, I, I, P, P, P]
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


def routed_gather(main, cache, delta, o_sh, o_sl, c_sh=None, c_sl=None,
                  use_c=None) -> torch.Tensor:
    """out[i] = use_c[i] ? fill(cache+delta)[c_sh, c_sl] : fill(main)[o_sh,
    o_sl] over [S, slots, L] f32 pools and [n] int32 coordinates;
    `cache is None` is the main-only form. Returns a new [n, L]."""
    full = cache is not None
    idx = (o_sh, o_sl) + ((c_sh, c_sl, use_c) if full else ())
    if not _on_cuda(main, cache, delta, *idx):
        return routed_gather_plain(main, cache, delta, o_sh, o_sl, c_sh,
                                   c_sl, use_c)
    S, R, L = main.shape
    n = o_sh.numel()
    for t in (main,) + ((cache, delta) if full else ()):
        _require(t.dtype == torch.float32 and t.dim() == 3
                 and t.is_contiguous() and t.shape[-1] == L,
                 "routed_gather: pools must be contiguous f32 [S, slots, L]")
    for t in idx[:4] if full else idx:
        _require(t.dtype == torch.int32 and t.dim() == 1
                 and t.numel() == n and t.is_contiguous(),
                 "routed_gather: coordinates must be contiguous int32 [n]")
    cS = cR = 0
    if full:
        _require(use_c.dtype == torch.bool and use_c.numel() == n
                 and use_c.is_contiguous(),
                 "routed_gather: use_c must be contiguous bool [n]")
        _require(cache.shape == delta.shape,
                 "routed_gather: cache and delta shapes differ")
        cS, cR = cache.shape[0], cache.shape[1]
    out = torch.empty((n, L), dtype=torch.float32, device=main.device)
    if n == 0:
        return out
    vec = int(L % 4 == 0 and _aligned16(main, cache, delta, out))
    rc = _lib("routed_gather").adapm_routed_gather(
        _ptr(main), _ptr(cache), _ptr(delta), _ptr(o_sh), _ptr(o_sl),
        _ptr(c_sh) if full else None, _ptr(c_sl) if full else None,
        _ptr(use_c) if full else None, _ptr(out), n, S, R, cS, cR, L, vec,
        _stream())
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


def adagrad_update(g: torch.Tensor, acc: torch.Tensor, lr: float,
                   eps: float) -> torch.Tensor:
    """Delta row of the fused step: [-lr*g*rsqrt(acc + g^2 + eps) | g^2]
    for g [n, D] and acc [n, D] (acc may be the accumulator half of the
    gathered [n, 2D] rows: only its last dim must be contiguous).
    Returns a new [n, 2D]."""
    if not _on_cuda(g, acc):
        return adagrad_update_plain(g, acc, lr, eps)
    _require(g.dtype == torch.float32 and acc.dtype == torch.float32,
             "adagrad_update: f32 only")
    _require(g.dim() == 2 and acc.shape == g.shape,
             "adagrad_update: g and acc must both be [n, D]")
    _require(g.is_contiguous() and acc.stride(1) == 1,
             "adagrad_update: g must be contiguous and acc row-major")
    n, D = g.shape
    upd = torch.empty((n, 2 * D), dtype=torch.float32, device=g.device)
    if n == 0:
        return upd
    vec = int(D % 4 == 0 and acc.stride(0) % 4 == 0
              and _aligned16(g, acc, upd))
    rc = _lib("adagrad").adapm_adagrad_update(
        _ptr(g), _ptr(acc), acc.stride(0), _ptr(upd), n, D, float(lr),
        float(eps), vec, _stream())
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


def _flat_targets(pool: torch.Tensor, sh: torch.Tensor,
                  sl: torch.Tensor) -> torch.Tensor:
    """Flat row index per entry; out-of-range entries get S*R (one past
    the last row), which the scatter drops."""
    S, R, _ = pool.shape
    sh, sl = sh.long(), sl.long()
    ok = (sh >= 0) & (sh < S) & (sl >= 0) & (sl < R)
    return torch.where(ok, sh * R + sl, torch.full_like(sh, S * R))


def ordered_scatter_add_plain(pool, sh, sl, vals) -> None:
    """The plain version of K3: the same sorted runs, folded one
    occurrence rank at a time (the k-th occurrences of all targets are
    distinct rows, so each rank is one duplicate-free indexed add)."""
    S, R, L = pool.shape
    flat = _flat_targets(pool, sh, sl)
    n = flat.numel()
    if n == 0:
        return
    sf, perm = torch.sort(flat, stable=True)
    pos = torch.arange(n, device=flat.device)
    head = torch.ones(n, dtype=torch.bool, device=flat.device)
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


def ordered_scatter_add(pool: torch.Tensor, sh: torch.Tensor,
                        sl: torch.Tensor, vals: torch.Tensor) -> None:
    """In place: pool[sh[i], sl[i]] += vals[i] for every in-range entry,
    duplicates folded in batch order (np.add.at). pool [S, R, L] f32,
    sh/sl [n] int32, vals [n, L] f32."""
    if not _on_cuda(pool, sh, sl, vals):
        return ordered_scatter_add_plain(pool, sh, sl, vals)
    S, R, L = pool.shape
    n = sh.numel()
    _require(pool.dtype == torch.float32 and pool.is_contiguous(),
             "ordered_scatter_add: pool must be contiguous f32")
    _require(sh.dtype == torch.int32 and sl.dtype == torch.int32
             and sh.numel() == n and sl.numel() == n,
             "ordered_scatter_add: coordinates must be int32 [n]")
    _require(vals.dtype == torch.float32 and vals.is_contiguous()
             and tuple(vals.shape) == (n, L),
             "ordered_scatter_add: vals must be contiguous f32 [n, L]")
    if n == 0:
        return
    # ordering, not arithmetic: a stable sort groups each target's
    # occurrences into one run that keeps batch order
    sf, perm = torch.sort(_flat_targets(pool, sh, sl), stable=True)
    vec = int(L % 4 == 0 and _aligned16(pool, vals))
    rc = _lib("ordered_scatter").adapm_ordered_scatter_add(
        _ptr(pool), _ptr(sf), _ptr(perm), _ptr(vals), n, S * R, L, vec,
        _stream())
    LAUNCHES["ordered_scatter_add"] += 1
    _check(rc, "ordered_scatter_add")


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
    g_o = torch.zeros(B, dtype=torch.int32, device=pool.device)
    g_s = torch.zeros_like(g_o)
    if nvalid == 0 or B == 0:
        return g_o, g_s
    vec = int(L % 4 == 0 and K % 4 == 0 and _aligned16(pool, q_o, q_s))
    rc = _lib("pool_eval_counts").adapm_pool_eval_counts(
        _ptr(pool), S, R, L, K, _ptr(owner), _ptr(slot), owner.numel(),
        _ptr(keys), int(nvalid), _ptr(q_o), _ptr(q_s), _ptr(true_sc),
        _ptr(okey), _ptr(skey), B, vec, _ptr(g_o), _ptr(g_s), _stream())
    LAUNCHES["pool_eval_counts"] += 1
    _check(rc, "pool_eval_counts")
    return g_o, g_s
