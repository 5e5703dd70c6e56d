"""The DevicePort protocol: the narrow device-plane surface.

Every accelerator interaction the parameter manager performs — data-plane
gathers/scatters, the sync/relocation programs, the tiered wire-row
ingest, pool allocation and the collective exchange — goes through ONE
port object, so a backend is one port implementation, not a tree-wide
edit. This is the protocol of the JAX package's `device/port.py`,
carried over method for method.

The surface is index-shaped: port methods take pool tensors plus padded
(shard, slot/row) index buffers — exactly what `ShardedStore` computes —
and return the pool tensors. Semantics every implementation preserves:

  - **bit-exactness**: data-plane results are IEEE-f32 bit-identical to
    the JAX package's `JaxDevicePort` and `NumpyRefPort`;
  - **padding**: index entries carrying `OOB` are no-ops — dropped by
    scatters, zero-filled by gathers;
  - **negative coordinates**: the port follows `refport._valid` of the
    JAX package: any coordinate outside [0, n) — negative ones included
    — reads 0 and is dropped. The JAX package's `jaxport` differs here:
    XLA wraps an index in [-n, 0) before its fill/drop check, so a
    negative coordinate reads or writes row n + i there. No caller of
    either package passes one: the host validates keys, and routing
    turns an absent row (NO_SLOT, -1, in the Addressbook) into OOB
    before any program sees it. So the two agree on every path the
    parameter manager runs; the kernel tests hold negative cases to
    `NumpyRefPort`;
  - **in-place pools**: methods documented as updating pools return the
    (same) pool tensors after updating them in place; callers rebind
    from the return value, as they do under JAX's donation;
  - **asynchrony**: methods ENQUEUE device work and return.
"""
from __future__ import annotations

from typing import Optional


class DevicePort:
    """Abstract device-plane port (see module docstring). The shipping
    implementation is `TorchDevicePort` (device/torchport.py)."""

    name = "abstract"

    def stats(self) -> dict:
        """Host-side accounting for the `device` snapshot section."""
        raise NotImplementedError

    # -- data-plane programs (core/store.py ShardedStore) --------------------

    def gather(self, main, cache, delta, o_shard, o_slot, c_shard,
               c_slot, use_cache):
        raise NotImplementedError

    def gather_pool(self, main, cache, delta, o_shard, o_slot, c_shard,
                    c_slot, use_cache, seg, out, pooling="sum"):
        """Fused embedding-bag read: gather member rows as `gather` and
        reduce them into `out[seg[i]]` in batch order."""
        raise NotImplementedError

    def scatter_add(self, main, delta, o_shard, o_slot, d_shard,
                    d_slot, vals):
        """Updates (main, delta); returns (main, delta)."""
        raise NotImplementedError

    def set_rows(self, main, cache, delta, o_shard, o_slot, vals,
                 c_shard, c_slot):
        """Updates (main, cache, delta); returns the triple."""
        raise NotImplementedError

    def replica_create(self, main, cache, delta, o_shard, o_slot,
                       c_shard, c_slot):
        """Updates (cache, delta); returns (cache, delta)."""
        raise NotImplementedError

    def sync_replicas(self, main, cache, delta, r_shard, r_cslot,
                      o_shard, o_slot, threshold: float = 0.0,
                      compress: str = "off"):
        """One sync round. Updates (main, cache, delta) and returns the
        triple (plus the max-abs parked residual when `compress` is a
        wire mode)."""
        raise NotImplementedError

    def read_rows_at(self, arr, sh, sl):
        raise NotImplementedError

    def install_rows(self, cache, delta, c_shard, c_slot, vals):
        """Updates (cache, delta); returns (cache, delta)."""
        raise NotImplementedError

    def refresh_after_sync(self, cache, delta, c_shard, c_slot, fresh,
                           shipped):
        """Updates (cache, delta); returns (cache, delta)."""
        raise NotImplementedError

    def relocate(self, main, delta, old_shard, old_slot, new_shard,
                 new_slot, rc_shard, rc_slot):
        """Updates (main, delta); returns (main, delta)."""
        raise NotImplementedError

    # -- tiered cold path + wire-row ingest ----------------------------------

    def gather_cold(self, main, cache, delta, o_shard, o_row, c_shard,
                    c_slot, use_cache, cold_vals, use_cold):
        raise NotImplementedError

    def gather_cold_wire(self, mode: str, main, cache, delta, o_shard,
                         o_row, c_shard, c_slot, use_cache, cold_q,
                         cold_scale, use_cold):
        raise NotImplementedError

    def gather_pool_cold(self, main, cache, delta, o_shard, o_row,
                         c_shard, c_slot, use_cache, cold_vals,
                         use_cold, seg, out, pooling="sum"):
        raise NotImplementedError

    def gather_pool_cold_wire(self, mode: str, main, cache, delta,
                              o_shard, o_row, c_shard, c_slot,
                              use_cache, cold_q, cold_scale, use_cold,
                              seg, out, pooling="sum"):
        raise NotImplementedError

    def write_main_rows(self, main, sh, row, vals):
        raise NotImplementedError

    def write_main_rows_wire(self, mode: str, main, sh, row, qvals,
                             scales=None):
        raise NotImplementedError

    def clear_rows(self, arr, sh, sl):
        """Zero rows in place; returns arr."""
        raise NotImplementedError

    def install_cache_rows(self, cache, delta, c_shard, c_slot, vals,
                           resid=None):
        raise NotImplementedError

    # -- buffer allocation / transfer ----------------------------------------

    def alloc_pool(self, shape, dtype, device):
        """A zeroed pool tensor on `device`."""
        raise NotImplementedError

    def install_pool(self, arr, device):
        """Host array -> a pool tensor on `device` (a private copy)."""
        raise NotImplementedError

    def launder(self, x):
        """Bit-exact copy (a clone, never `x + 0`, which maps -0.0 to
        +0.0)."""
        raise NotImplementedError

    def put_replicated(self, arr, device):
        """Stage a host array on `device`."""
        raise NotImplementedError

    # -- program construction ------------------------------------------------

    def compile(self, fn, **kwargs):
        raise NotImplementedError

    def compile_collective(self, fn, mesh, in_specs, out_specs):
        raise NotImplementedError


_default: Optional[DevicePort] = None


def default_port() -> DevicePort:
    """The process-wide port. Construction is lazy."""
    global _default
    if _default is None:
        from .torchport import TorchDevicePort
        _default = TorchDevicePort()
    return _default


def set_default_port(port: Optional[DevicePort]) -> None:
    """Install a custom port (tests / alternative backends). None resets
    to lazy TorchDevicePort construction."""
    global _default
    _default = port
