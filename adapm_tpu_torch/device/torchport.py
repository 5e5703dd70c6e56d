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
    row the LAST wins (`refport._drop_set`), resolved on the card with no
    sort (K14 `drop_set`: a claim, then only the winner writes); a base
    and its delta are set by one claim (K14's install form), reading the
    source row where it lies when it is another pool's row;
  - a planner round (K15 `sync_round`) folds each replica's delta row,
    read where it lies, into its owner in batch order, then K14's
    install form sets the fresh owner row as the base and zeros the
    delta;
  - copies are clones and choices are selects, so -0.0 survives;
  - a bag read (K8 `gather_pool`) folds its member rows into their
    bags in batch order, as the scatter-adds do;
  - a tiered store's cold rows arrive staged beside the batch in their
    wire format (tier/quant.py: fp32, fp16, int8 with a per-row scale)
    and are dequantized inside the read (K9 `gather_cold`, K10
    `gather_pool_cold`) or the promotion upload (K11
    `write_main_rows`), bit for bit as the host twins dequantize;
  - a compressed sync round quantizes the replica deltas with K12
    `sync_compress` and parks the residual in the delta row.

Pools are UPDATED IN PLACE and returned: where JAX donates a buffer and
returns its replacement, this port writes into the caller's tensor, and
every program reads all its inputs before its first write (relocate,
sync), so in-place order cannot change a result.

Index arguments arrive as padded int32 numpy arrays (or tensors) and
are staged onto the pool's device here. On the card, the wire rows, scales
and masks of a cold read or a promotion are copied through a ring of
pinned host buffers per dtype (ops/fused.py _PinnedRing), so the copy
is queued without the host waiting on it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..exec import dispatch_gate
from ..ops.kernels import (F16_MAX, WIRE_DTYPES,  # noqa: F401 (F16_MAX)
                           drop_set, drop_set_install, drop_set_zero,
                           gather_cold, gather_pool, gather_pool_cold,
                           ordered_scatter_add, routed_gather, sync_compress,
                           sync_round, write_main_rows)
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


def _non_decreasing(seg) -> bool:
    """Whether a bag-index array is non-decreasing, read on the host: a
    numpy array (the store's, as the serving path builds it) or a CPU
    tensor. A CUDA tensor answers False (no device sync): K8 then orders
    its members first."""
    if isinstance(seg, torch.Tensor):
        if seg.device.type != "cpu":
            return False
        seg = seg.numpy()
    seg = np.asarray(seg)
    return bool((seg[1:] >= seg[:-1]).all())


def _count(mask) -> int:
    """True entries of a host mask (a numpy array or a tensor)."""
    if isinstance(mask, torch.Tensor):
        return int(mask.count_nonzero())
    return int(np.count_nonzero(np.asarray(mask)))


def fill_gather(pool: torch.Tensor, sh: torch.Tensor,
                sl: torch.Tensor) -> torch.Tensor:
    """`pool.at[sh, sl].get(mode="fill", fill_value=0)` (K1, main-only)."""
    return routed_gather(pool, None, None, sh, sl)


class TorchDevicePort(DevicePort):
    """The PyTorch DevicePort (module docstring)."""

    name = "torch"
    # pinned staging buffers per dtype of wire rows: a cold read's
    # buffer is the padded batch of rows, so the ring stays short
    WIRE_SLOTS = 4

    def __init__(self):
        # lock-free liveness-grade counters (a racing increment may be
        # lost); they feed the `device` snapshot section
        self.programs = 0
        self.wire_ingest_rows = 0
        self._rings = {}   # numpy dtype -> pinned staging ring (_stage)

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
        with _GATE:
            drop_set(main, _idx(o_shard, d), _idx(o_slot, d), v)
            drop_set_install(cache, delta, _idx(c_shard, d),
                             _idx(c_slot, d), rows=v)
        return main, cache, delta

    def replica_create(self, main, cache, delta, o_shard, o_slot,
                       c_shard, c_slot):
        self.programs += 1
        d = main.device
        with _GATE:
            drop_set_install(cache, delta, _idx(c_shard, d),
                             _idx(c_slot, d),
                             src=(main, _idx(o_shard, d), _idx(o_slot, d)))
        return cache, delta

    def sync_replicas(self, main, cache, delta, r_shard, r_cslot,
                      o_shard, o_slot, threshold: float = 0.0,
                      compress: str = "off"):
        self.programs += 1
        d = main.device
        r_sh, r_cs = _idx(r_shard, d), _idx(r_cslot, d)
        o_sh, o_sl = _idx(o_shard, d), _idx(o_slot, d)
        if compress != "off":
            return self._sync_compressed(main, cache, delta, r_sh, r_cs,
                                         o_sh, o_sl, threshold, compress)
        with _GATE:
            # merge into owners (ordered) -> refresh bases, clear deltas
            sync_round(main, cache, delta, r_sh, r_cs, o_sh, o_sl,
                       threshold)
        return main, cache, delta

    @staticmethod
    def _sync_compressed(main, cache, delta, r_sh, r_cs, o_sh, o_sl,
                         threshold, mode):
        """A compressed round in the order of the JAX program
        (_sync_replicas_compressed): K12 quantizes the deltas and parks
        the residuals, K3 merges the shipped rows into the owners (held
        rows' coordinates OOB), and K14's install form sets each shipped
        replica's fresh owner row, read where it lies, as its base and its
        residual as its delta. A held row's new delta is its delta as it
        was (K12 passes it through), so it is left unwritten. Returns the
        pools and the max-abs parked residual (a device scalar)."""
        with _GATE:
            shipped, new_delta, ship, norm = sync_compress(
                delta, r_sh, r_cs, mode, threshold)
            oob = torch.full_like(r_cs, int(OOB))
            rs = torch.where(ship, r_cs, oob)
            osl = torch.where(ship, o_sl, oob)
            ordered_scatter_add(main, o_sh, osl, shipped)
            drop_set_install(cache, delta, r_sh, rs, src=(main, o_sh, osl),
                             resid=new_delta)
        return main, cache, delta, norm

    def read_rows_at(self, arr, sh, sl):
        self.programs += 1
        d = arr.device
        with _GATE:
            return fill_gather(arr, _idx(sh, d), _idx(sl, d))

    def install_rows(self, cache, delta, c_shard, c_slot, vals):
        self.programs += 1
        d = cache.device
        v = _vals(vals, cache)
        with _GATE:
            drop_set_install(cache, delta, _idx(c_shard, d), _idx(c_slot, d),
                             rows=v)
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
            drop_set_zero(delta, rc_sh, rc_sl)
        return main, delta

    def clear_rows(self, arr, sh, sl):
        self.programs += 1
        d = arr.device
        with _GATE:
            drop_set_zero(arr, _idx(sh, d), _idx(sl, d))
        return arr

    @staticmethod
    def _pool_out(out, main) -> torch.Tensor:
        """A bag read's `out`, as a contiguous f32 tensor on the pools'
        device (copied there unless it already is one)."""
        if isinstance(out, torch.Tensor) and out.device == main.device \
                and out.dtype == main.dtype and out.is_contiguous():
            return out
        return torch.tensor(np.asarray(out), dtype=main.dtype,
                            device=main.device)

    def gather_pool(self, main, cache, delta, o_shard, o_slot, c_shard,
                    c_slot, use_cache, seg, out, pooling="sum"):
        """K8. `out` is consumed: a f32 tensor on the pools' device is
        pooled into in place; anything else is copied there first."""
        self.programs += 1
        d = main.device
        out = self._pool_out(out, main)
        with _GATE:
            return gather_pool(main, cache, delta, _idx(o_shard, d),
                               _idx(o_slot, d), _idx(c_shard, d),
                               _idx(c_slot, d), _mask(use_cache, d),
                               _idx(seg, d), out, pooling,
                               sorted_seg=_non_decreasing(seg))

    # -- tiered cold path + wire ingest --------------------------------------

    def _stage(self, x, device, dtype) -> torch.Tensor:
        """A host array of wire rows, scales or a mask on `device` (call
        under the gate). On the card it is copied through the pinned
        ring of its dtype, queued on the stream."""
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype).contiguous()
        a = np.ascontiguousarray(x)
        if device.type != "cuda":
            return torch.as_tensor(a).to(dtype)
        a = a.astype(torch.empty(0, dtype=dtype).numpy().dtype, copy=False)
        from ..ops.fused import _PinnedRing
        ring = self._rings.get(a.dtype)
        if ring is None:
            ring = self._rings[a.dtype] = _PinnedRing(self.WIRE_SLOTS)
        return ring.upload([a], device).view(a.shape)

    def _cold_rows(self, mode, cold, scale, use_cold, device):
        wire = self._stage(cold, device, WIRE_DTYPES[mode])
        sc = None if mode != "int8" else \
            self._stage(scale, device, torch.float32)
        return wire, sc, self._stage(use_cold, device, torch.bool)

    def _cold_read(self, mode, main, cache, delta, o_shard, o_row,
                   c_shard, c_slot, use_cache, cold, scale, use_cold):
        d = main.device
        with _GATE:
            q, sc, uc = self._cold_rows(mode, cold, scale, use_cold, d)
            return gather_cold(main, cache, delta, _idx(o_shard, d),
                               _idx(o_row, d), _idx(c_shard, d),
                               _idx(c_slot, d), _mask(use_cache, d), mode,
                               q, sc, uc)

    def _cold_pool(self, mode, main, cache, delta, o_shard, o_row,
                   c_shard, c_slot, use_cache, cold, scale, use_cold, seg,
                   out, pooling):
        d = main.device
        out = self._pool_out(out, main)
        with _GATE:
            q, sc, uc = self._cold_rows(mode, cold, scale, use_cold, d)
            return gather_pool_cold(
                main, cache, delta, _idx(o_shard, d), _idx(o_row, d),
                _idx(c_shard, d), _idx(c_slot, d), _mask(use_cache, d),
                mode, q, sc, uc, _idx(seg, d), out, pooling,
                sorted_seg=_non_decreasing(seg))

    def gather_cold(self, main, cache, delta, o_shard, o_row, c_shard,
                    c_slot, use_cache, cold_vals, use_cold):
        """K9 with f32 cold rows."""
        self.programs += 1
        return self._cold_read("fp32", main, cache, delta, o_shard, o_row,
                               c_shard, c_slot, use_cache, cold_vals, None,
                               use_cold)

    def gather_cold_wire(self, mode: str, main, cache, delta, o_shard,
                         o_row, c_shard, c_slot, use_cache, cold_q,
                         cold_scale, use_cold):
        """K9 with fp16 or int8 wire rows, dequantized in the read."""
        self.programs += 1
        # real wire rows only: the padded bucket would inflate the count
        self.wire_ingest_rows += _count(use_cold)
        return self._cold_read(mode, main, cache, delta, o_shard, o_row,
                               c_shard, c_slot, use_cache, cold_q,
                               cold_scale, use_cold)

    def gather_pool_cold(self, main, cache, delta, o_shard, o_row,
                         c_shard, c_slot, use_cache, cold_vals,
                         use_cold, seg, out, pooling="sum"):
        """K10 with f32 cold rows."""
        self.programs += 1
        return self._cold_pool("fp32", main, cache, delta, o_shard, o_row,
                               c_shard, c_slot, use_cache, cold_vals, None,
                               use_cold, seg, out, pooling)

    def gather_pool_cold_wire(self, mode: str, main, cache, delta,
                              o_shard, o_row, c_shard, c_slot,
                              use_cache, cold_q, cold_scale, use_cold,
                              seg, out, pooling="sum"):
        """K10 with fp16 or int8 wire rows."""
        self.programs += 1
        self.wire_ingest_rows += _count(use_cold)
        return self._cold_pool(mode, main, cache, delta, o_shard, o_row,
                               c_shard, c_slot, use_cache, cold_q,
                               cold_scale, use_cold, seg, out, pooling)

    def write_main_rows(self, main, sh, row, vals):
        """K11 with f32 rows: the promotion upload (and its exact fixup
        rows). Updates `main` in place, never reallocating it."""
        self.programs += 1
        return self._write_rows("fp32", main, sh, row, vals, None)

    def write_main_rows_wire(self, mode: str, main, sh, row, qvals,
                             scales=None):
        """K11 with fp16 or int8 rows, dequantized in the write."""
        self.programs += 1
        # real wire rows only (padding rows carry OOB and drop)
        self.wire_ingest_rows += _count(np.asarray(row) != OOB)
        return self._write_rows(mode, main, sh, row, qvals, scales)

    def _write_rows(self, mode, main, sh, row, q, scale):
        d = main.device
        with _GATE:
            wire = self._stage(q, d, WIRE_DTYPES[mode])
            sc = None if mode != "int8" else \
                self._stage(scale, d, torch.float32)
            return write_main_rows(main, _idx(sh, d), _idx(row, d), mode,
                                   wire, sc)

    def install_cache_rows(self, cache, delta, c_shard, c_slot, vals,
                           resid=None):
        """Set replica bases to `vals` and their deltas to `resid` (zeros
        when None): the cold-owner sync refresh (tier/coldpath.py)."""
        self.programs += 1
        d = cache.device
        v = _vals(vals, cache)
        r = None if resid is None else _vals(resid, delta)
        with _GATE:
            drop_set_install(cache, delta, _idx(c_shard, d), _idx(c_slot, d),
                             rows=v, resid=r)
        return cache, delta

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
            "the port compiles no program from a function: its steps run "
            "eagerly, and K-step windows are captured as CUDA graphs by "
            "ops/fused.py DeviceRoutedRunner.run_scan")

    def compile_collective(self, fn, mesh, in_specs="p", out_specs="p"):
        """The collective exchange over the process list `mesh`
        (parallel/mesh.py ProcessMesh) where the JAX port builds a
        shard_map program over a one-device-per-process mesh. The one
        collective program the PM uses is the leafwise all-to-all over
        the process axis (`fn="all_to_all"`, specs on that axis); it
        returns parallel/exchange.py SlabExchange: K13 on the card, the
        plain version for a CPU context."""
        if fn != "all_to_all" or in_specs != mesh.axis or \
                out_specs != mesh.axis:
            raise ValueError(
                "the port builds one collective program: the all-to-all "
                f"over the process axis {mesh.axis!r} (got fn={fn!r}, "
                f"in_specs={in_specs!r}, out_specs={out_specs!r})")
        from ..parallel.exchange import SlabExchange
        self.programs += 1
        return SlabExchange(mesh)
