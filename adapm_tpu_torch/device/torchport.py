"""TorchDevicePort: the DevicePort over PyTorch tensors and the port's
hand-written CUDA kernels.

Each method is the counterpart of one jitted program of the JAX
package's `device/jaxport.py`, with the same semantics, bit for bit:

  - gathers read 0 for any out-of-range (shard, slot) entry (K1
    `routed_gather`; a negative index never wraps);
  - scatter-adds drop out-of-range entries and fold duplicates into the
    stored row in batch order (K3 `ordered_scatter_add`, `np.add.at`
    semantics);
  - sets drop out-of-range entries, and of several entries naming one
    row the LAST wins (`refport._drop_set`), resolved before the write;
  - copies are clones and choices are selects, so -0.0 survives.

Pools are UPDATED IN PLACE and returned: where JAX donates a buffer and
returns its replacement, this port writes into the caller's tensor, and
every program reads all its inputs before its first write (relocate,
sync), so in-place order cannot change a result.

Index arguments arrive as padded int32 numpy arrays (or tensors) and
are staged onto the pool's device here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..exec import dispatch_gate
from ..ops.kernels import ordered_scatter_add, routed_gather
from .port import DevicePort

_GATE = dispatch_gate()

# out-of-range slot index for padding / masked entries: dropped by
# scatters, zero-filled by gathers (the JAX package's sentinel)
OOB = np.int32(2**31 - 2)


def _idx(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                           device=device)


def _mask(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bool).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x, dtype=bool),
                           device=device)


def _vals(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=like.dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x),
                           device=like.device).to(like.dtype)


def drop_set(pool: torch.Tensor, sh: torch.Tensor, sl: torch.Tensor,
             vals: torch.Tensor) -> None:
    """In place `pool.at[sh, sl].set(vals, mode="drop")`: out-of-range
    entries are skipped; of several entries naming one row, the last in
    batch order wins (deduplicated here: an indexed write with duplicate
    indices has no defined winner on CUDA)."""
    S, R, L = pool.shape
    sh, sl = sh.long(), sl.long()
    ok = (sh >= 0) & (sh < S) & (sl >= 0) & (sl < R)
    flat = torch.where(ok, sh * R + sl, torch.full_like(sh, -1))
    sf, order = torch.sort(flat, stable=True)
    last = torch.ones_like(sf, dtype=torch.bool)
    last[:-1] = sf[:-1] != sf[1:]
    keep = order[last & (sf >= 0)]
    pool.view(S * R, L)[flat[keep]] = vals[keep]


def fill_gather(pool: torch.Tensor, sh: torch.Tensor,
                sl: torch.Tensor) -> torch.Tensor:
    """`pool.at[sh, sl].get(mode="fill", fill_value=0)` (K1, main-only)."""
    return routed_gather(pool, None, None, sh, sl)


class TorchDevicePort(DevicePort):
    """The PyTorch DevicePort (module docstring)."""

    name = "torch"

    def __init__(self):
        # lock-free liveness-grade counters (a racing increment may be
        # lost); they feed the `device` snapshot section
        self.programs = 0
        self.wire_ingest_rows = 0

    def stats(self) -> dict:
        return {"backend": self.name,
                "programs_total": int(self.programs),
                "wire_ingest_rows_total": int(self.wire_ingest_rows)}

    # -- data-plane programs -------------------------------------------------

    def gather(self, main, cache, delta, o_shard, o_slot, c_shard,
               c_slot, use_cache):
        self.programs += 1
        d = main.device
        with _GATE:
            return routed_gather(main, cache, delta, _idx(o_shard, d),
                                 _idx(o_slot, d), _idx(c_shard, d),
                                 _idx(c_slot, d), _mask(use_cache, d))

    def scatter_add(self, main, delta, o_shard, o_slot, d_shard,
                    d_slot, vals):
        self.programs += 1
        d = main.device
        v = _vals(vals, main)
        with _GATE:
            ordered_scatter_add(main, _idx(o_shard, d), _idx(o_slot, d), v)
            ordered_scatter_add(delta, _idx(d_shard, d), _idx(d_slot, d), v)
        return main, delta

    def set_rows(self, main, cache, delta, o_shard, o_slot, vals,
                 c_shard, c_slot):
        self.programs += 1
        d = main.device
        v = _vals(vals, main)
        c_sh, c_sl = _idx(c_shard, d), _idx(c_slot, d)
        with _GATE:
            drop_set(main, _idx(o_shard, d), _idx(o_slot, d), v)
            drop_set(cache, c_sh, c_sl, v)
            drop_set(delta, c_sh, c_sl, torch.zeros_like(v))
        return main, cache, delta

    def replica_create(self, main, cache, delta, o_shard, o_slot,
                       c_shard, c_slot):
        self.programs += 1
        d = main.device
        c_sh, c_sl = _idx(c_shard, d), _idx(c_slot, d)
        with _GATE:
            rows = fill_gather(main, _idx(o_shard, d), _idx(o_slot, d))
            drop_set(cache, c_sh, c_sl, rows)
            drop_set(delta, c_sh, c_sl, torch.zeros_like(rows))
        return cache, delta

    def sync_replicas(self, main, cache, delta, r_shard, r_cslot,
                      o_shard, o_slot, threshold: float = 0.0,
                      compress: str = "off"):
        if compress != "off":
            raise NotImplementedError(
                "compressed sync rounds (--sys.sync.compress) are not "
                "ported yet (ROADMAP queue B, B8)")
        self.programs += 1
        d = main.device
        r_sh, r_cs = _idx(r_shard, d), _idx(r_cslot, d)
        o_sh, o_sl = _idx(o_shard, d), _idx(o_slot, d)
        with _GATE:
            # extract -> merge into owners (ordered) -> re-gather the
            # fresh owner rows -> refresh bases, clear deltas
            dvals = fill_gather(delta, r_sh, r_cs)
            if threshold > 0.0:
                thr = torch.tensor(threshold, dtype=main.dtype, device=d)
                ship = dvals.abs().amax(dim=1) >= thr
                oob = torch.full_like(r_cs, int(OOB))
                r_cs = torch.where(ship, r_cs, oob)
                o_sl = torch.where(ship, o_sl, oob)
            ordered_scatter_add(main, o_sh, o_sl, dvals)
            fresh = fill_gather(main, o_sh, o_sl)
            drop_set(cache, r_sh, r_cs, fresh)
            drop_set(delta, r_sh, r_cs, torch.zeros_like(fresh))
        return main, cache, delta

    def read_rows_at(self, arr, sh, sl):
        self.programs += 1
        d = arr.device
        with _GATE:
            return fill_gather(arr, _idx(sh, d), _idx(sl, d))

    def install_rows(self, cache, delta, c_shard, c_slot, vals):
        self.programs += 1
        d = cache.device
        v = _vals(vals, cache)
        c_sh, c_sl = _idx(c_shard, d), _idx(c_slot, d)
        with _GATE:
            drop_set(cache, c_sh, c_sl, v)
            drop_set(delta, c_sh, c_sl, torch.zeros_like(v))
        return cache, delta

    def refresh_after_sync(self, cache, delta, c_shard, c_slot, fresh,
                           shipped):
        self.programs += 1
        d = cache.device
        c_sh, c_sl = _idx(c_shard, d), _idx(c_slot, d)
        with _GATE:
            drop_set(cache, c_sh, c_sl, _vals(fresh, cache))
            ordered_scatter_add(delta, c_sh, c_sl,
                                -_vals(shipped, delta))
        return cache, delta

    def relocate(self, main, delta, old_shard, old_slot, new_shard,
                 new_slot, rc_shard, rc_slot):
        self.programs += 1
        d = main.device
        rc_sh, rc_sl = _idx(rc_shard, d), _idx(rc_slot, d)
        with _GATE:
            # every read before any write: a batch may reuse a slot it
            # frees
            rows = fill_gather(main, _idx(old_shard, d), _idx(old_slot, d))
            rows = rows + fill_gather(delta, rc_sh, rc_sl)
            drop_set(main, _idx(new_shard, d), _idx(new_slot, d), rows)
            drop_set(delta, rc_sh, rc_sl, torch.zeros_like(rows))
        return main, delta

    def clear_rows(self, arr, sh, sl):
        self.programs += 1
        d = arr.device
        sh = _idx(sh, d)
        with _GATE:
            drop_set(arr, sh, _idx(sl, d),
                     torch.zeros((sh.numel(), arr.shape[-1]),
                                 dtype=arr.dtype, device=d))
        return arr

    # -- not ported yet: bag reads, tiered cold path, wire ingest ------------

    def gather_pool(self, *args, **kwargs):
        raise NotImplementedError("fused embedding-bag reads are not "
                                  "ported yet (ROADMAP queue B, B7)")

    def _cold(self, *args, **kwargs):
        raise NotImplementedError("the tiered cold path and wire ingest "
                                  "are not ported yet (ROADMAP queue B, "
                                  "B8; queue A, item 8)")

    gather_cold = gather_cold_wire = gather_pool_cold = _cold
    gather_pool_cold_wire = write_main_rows = write_main_rows_wire = _cold
    install_cache_rows = _cold

    # -- buffer allocation / transfer ----------------------------------------

    def alloc_pool(self, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)

    def install_pool(self, arr, device):
        # np.array copies: the tensor never aliases the caller's array
        return torch.from_numpy(np.array(arr)).to(device)

    def launder(self, x):
        self.programs += 1
        return x.clone()

    def put_replicated(self, arr, device):
        if isinstance(arr, torch.Tensor):
            return arr.to(device)
        return torch.as_tensor(np.asarray(arr), device=device)

    # -- program construction ------------------------------------------------

    def compile(self, fn, **kwargs):
        raise NotImplementedError(
            "the port runs its steps eagerly; multi-step capture "
            "(run_scan as a CUDA graph) is ROADMAP queue A, item 4")

    def compile_collective(self, fn, mesh, in_specs, out_specs):
        raise NotImplementedError("the collective exchange is not ported "
                                  "yet (ROADMAP queue B, B10)")
