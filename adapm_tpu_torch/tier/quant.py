"""Quantized cold-tier storage and the shared wire-format transforms:
the port's own copy of the JAX package's `tier/quant.py` (numpy only).

The cold store holds the authoritative value of every main row that is
not device-hot. `--sys.tier.cold_dtype` trades precision for host bytes
per row under an explicit numeric contract (docs/MEMORY.md "Cold-row
numeric contract"):

  fp32   4L bytes/row — bit-identical.
  fp16   2L bytes/row — exact where the value is fp16-representable;
         otherwise round-to-nearest-even with per-row error feedback.
  int8   L + 4 bytes/row — symmetric per-row scale (max-abs / 127,
         rounded through fp16, the 2-byte wire scale); exact on the
         row's int grid, error-compensated otherwise.

Error feedback: every lossy write folds the row's true f32 value
(stored value + parked residual + the update) and re-quantizes; the new
remainder parks in a bounded host-side residual map and folds into the
next promote, write or relocation. The visible value of a cold row is
always its DEQUANTIZED stored value, so it is the same through the
card's dequantizing kernels (K9-K11, ops/kernels.py) and the host reads
here. The residual map is bounded (`resid_cap` rows); an overflow
evicts the oldest entry and is counted in `tier.ef_evicted`.

The device kernels must dequantize and quantize bit for bit as these
host twins do: IEEE f32 division and multiplication with no
contraction, f16 round-to-nearest-even, and round-half-to-even (numpy's
`round`, `rintf` in CUDA).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

COLD_DTYPES = ("fp32", "fp16", "int8")
SYNC_COMPRESS_MODES = ("off", "fp16", "int8")

# bytes of the per-row scale column on the wire (int8 modes): the f32
# scale is rounded through fp16, so a transport ships 2 bytes
_SCALE_WIRE_BYTES = 2

# largest finite fp16 value. Every f16 cast below clips to it first: a
# value (or int8 scale) beyond the range would cast to inf, and an inf
# stored/shipped value poisons the EF loop with inf - inf = NaN. The
# clipped excess rides the residual like any other remainder — for
# at-rest rows the visible value SATURATES at the format max until a
# promote folds the residual back (an inherent fp16-format limit; the
# two-grid-step bound applies to in-range values). Must stay equal to
# ops/kernels.py F16_MAX and csrc/quant.cuh kF16Max: device and host
# transforms agree bitwise.
F16_MAX = np.float32(65504.0)


def grid_step(mode: str, rows: np.ndarray) -> np.ndarray:
    """Per-row quantization grid step of `mode` for f32 `rows` of shape
    [..., L]: the unit the numeric contract (docs/MEMORY.md "Cold-row
    numeric contract") is stated in — visible error is bounded by TWO
    of these (one at-rest rounding + one parked residual's slack)."""
    m = np.max(np.abs(rows), axis=-1)
    if mode == "fp16":
        return m * np.float32(2.0 ** -11)
    if mode == "int8":
        return m / np.float32(127.0)
    raise ValueError(f"no grid step for mode {mode!r}")


def wire_bytes_per_row(mode: str, value_length: int) -> int:
    """Bytes one row (or one shipped delta) of `value_length` f32
    elements costs in wire/at-rest format `mode` ("off"/"fp32" = full
    width)."""
    if mode in ("off", "fp32"):
        return 4 * value_length
    if mode == "fp16":
        return 2 * value_length
    if mode == "int8":
        return value_length + _SCALE_WIRE_BYTES
    raise ValueError(f"unknown compression mode {mode!r}")


def int8_scale(rows: np.ndarray) -> np.ndarray:
    """Symmetric per-row int8 scale: max-abs / 127, rounded through
    fp16 (the 2-byte wire scale; clipped to the f16 range — see
    F16_MAX). f32 in, f32 out."""
    s = (np.max(np.abs(rows), axis=-1) / np.float32(127.0))
    return np.clip(s, 0.0, F16_MAX).astype(np.float16).astype(np.float32)


def quantize_rows(mode: str, rows: np.ndarray
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """f32 rows -> (wire rows, per-row scale or None). The transform
    the device programs invert; see module doc for the exactness
    contract."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    if mode == "fp32":
        return rows, None
    if mode == "fp16":
        return np.clip(rows, -F16_MAX, F16_MAX).astype(np.float16), None
    if mode == "int8":
        s = int8_scale(rows)
        safe = np.where(s > 0, s, np.float32(1.0)).astype(np.float32)
        q = np.clip(np.round(rows / safe[..., None]), -127, 127)
        return q.astype(np.int8), s
    raise ValueError(f"unknown cold dtype {mode!r}")


def dequantize_rows(mode: str, q: np.ndarray,
                    scale: Optional[np.ndarray]) -> np.ndarray:
    """Invert quantize_rows (the VISIBLE value of a stored row)."""
    if mode == "fp32":
        return np.asarray(q, dtype=np.float32).copy()
    if mode == "fp16":
        return q.astype(np.float32)
    if mode == "int8":
        return q.astype(np.float32) * scale[..., None]
    raise ValueError(f"unknown cold dtype {mode!r}")


def compress_delta(mode: str, dvals: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One sync round's wire transform on host: f32 deltas ->
    (shipped f32 values as the receiver reconstructs them, EF
    residual). Bit for bit K12 `sync_compress` (ops/kernels.py): the
    tiered cold-owner sync path (tier/coldpath.py) runs this on host and
    must agree with the device rounds."""
    dvals = np.ascontiguousarray(dvals, dtype=np.float32)
    q, s = quantize_rows(mode, dvals)
    shipped = dequantize_rows(mode, q, s)
    return shipped, dvals - shipped


class QuantCold:
    """One length class's cold store in `mode` format (see module doc).

    API mirrors the raw ndarray ops tier/coldpath.py used against the
    fp32 array, so fp32 mode is a bit-identical passthrough:

      read(sh, sl)          visible f32 rows (deq; fancy-index copy)
      add_at(sh, sl, rows)  additive merge, in-batch duplicates
                            accumulating in batch order (np.add.at)
      set_at(sh, sl, rows)  overwrite (duplicate coords: last wins)
      take_true(sh, sl)     full-precision rows (deq + residual),
                            CONSUMING the residuals — the move/promote
                            read
      promote_wire(...)     wire rows for the dequant-fused promotion
                            scatter + the residual fixups, consumed

    Mutating calls run under the server lock (the cold store is part
    of the residency-guarded state); gauges read lock-free.
    """

    def __init__(self, num_shards: int, main_slots: int,
                 value_length: int, mode: str = "fp32",
                 resid_cap: int = 65536):
        if mode not in COLD_DTYPES:
            raise ValueError(
                f"--sys.tier.cold_dtype must be one of {COLD_DTYPES} "
                f"(got {mode!r})")
        self.mode = mode
        self.value_length = value_length
        self.num_shards = num_shards
        self.main_slots = main_slots
        np_dtype = {"fp32": np.float32, "fp16": np.float16,
                    "int8": np.int8}[mode]
        self.q = np.zeros((num_shards, main_slots, value_length),
                          dtype=np_dtype)
        self.scale = (np.zeros((num_shards, main_slots), dtype=np.float32)
                      if mode == "int8" else None)
        # parked sub-grid remainders, (shard, slot) -> f32 row; bounded
        # (dict preserves insertion order -> FIFO eviction)
        # an OrderedDict, not a dict: evicting the oldest entry is
        # popitem(last=False), O(1), where a dict's next(iter(d)) walks
        # the deleted entries at its front (quadratic under a long run of
        # evictions); the order is the same (a re-set entry keeps its
        # place in both)
        self.resid: "OrderedDict[Tuple[int, int], np.ndarray]" = \
            OrderedDict()
        self.resid_cap = max(1, resid_cap)
        self.ef_evicted = 0   # residual rows dropped at the cap
        self.ef_folds = 0     # lossy write events that re-quantized

    # -- geometry / accounting (gauges; lock-free reads) -----------------

    @property
    def shape(self):
        return self.q.shape

    def nbytes(self) -> int:
        """Actual host bytes of the cold tier: stored rows + scale
        column + parked residuals (tier.cold_bytes_per_row counts ALL
        of it — the honest bytes/row, not just the dense array)."""
        n = self.q.nbytes
        if self.scale is not None:
            n += self.scale.nbytes
        n += len(self.resid) * self.value_length * 4
        return n

    def bytes_per_row(self) -> float:
        return self.nbytes() / float(self.num_shards * self.main_slots)

    def resid_rows(self) -> int:
        return len(self.resid)

    # -- internal helpers ------------------------------------------------

    def _true_rows(self, sh: np.ndarray, sl: np.ndarray,
                   consume: bool) -> np.ndarray:
        """deq + parked residual per (sh, sl) entry; consume=True
        deletes the folded residual entries (move/promote semantics)."""
        out = dequantize_rows(
            self.mode, self.q[sh, sl],
            self.scale[sh, sl] if self.scale is not None else None)
        if self.resid:
            for i, (s, l) in enumerate(zip(sh.tolist(), sl.tolist())):
                r = self.resid.get((s, l))
                if r is not None:
                    out[i] += r
                    if consume:
                        del self.resid[(s, l)]
        return out

    def _park(self, sh: np.ndarray, sl: np.ndarray,
              resid: np.ndarray) -> None:
        """Park per-row residuals (replacing any prior entry); all-zero
        rows clear instead — exact quantizations cost no bytes. The
        common all-exact / empty-map case is a vectorized no-op (this
        runs under the server lock on every quantized cold write)."""
        self.ef_folds += 1
        nz = resid.any(axis=1)
        if not nz.any() and not self.resid:
            return
        sh_l, sl_l = sh.tolist(), sl.tolist()
        n = len(sh_l)
        pair = np.asarray(sh, np.int64) * np.int64(self.main_slots) \
            + np.asarray(sl, np.int64)
        # iterate LAST occurrences only (duplicate coordinates: last
        # wins — the fancy-assignment semantics the per-row loop had)
        _, rev_first = np.unique(pair[::-1], return_index=True)
        clearing = bool(self.resid)
        for i in ((n - 1) - rev_first):
            if nz[i]:
                self.resid[(sh_l[i], sl_l[i])] = resid[i].copy()
            elif clearing:
                self.resid.pop((sh_l[i], sl_l[i]), None)
        while len(self.resid) > self.resid_cap:
            # FIFO eviction: injects <= half a grid step once, counted
            self.resid.popitem(last=False)
            self.ef_evicted += 1

    def _store_rows(self, sh: np.ndarray, sl: np.ndarray,
                    vals: np.ndarray) -> None:
        """Quantize `vals` into (sh, sl) and park the remainders.
        Duplicate coordinates: last occurrence wins on BOTH the stored
        row and the residual (numpy fancy-assignment semantics)."""
        q, s = quantize_rows(self.mode, vals)
        self.q[sh, sl] = q
        if self.scale is not None:
            self.scale[sh, sl] = s
        resid = vals - dequantize_rows(self.mode, q, s)
        self._park(sh, sl, resid)

    # -- the coldpath surface --------------------------------------------

    def read(self, sh: np.ndarray, sl: np.ndarray) -> np.ndarray:
        """Visible f32 values (deq only — residuals are private)."""
        if self.mode == "fp32":
            return self.q[sh, sl]
        return dequantize_rows(
            self.mode, self.q[sh, sl],
            self.scale[sh, sl] if self.scale is not None else None)

    def take_true(self, sh: np.ndarray, sl: np.ndarray) -> np.ndarray:
        """Full-precision rows for a MOVE (relocation source): deq +
        residual, consuming the residual — the value leaves with all
        its error-feedback state."""
        if self.mode == "fp32":
            return self.q[sh, sl]
        return self._true_rows(sh, sl, consume=True)

    def drop_resid(self, sh: np.ndarray, sl: np.ndarray) -> None:
        """Forget residuals of slots leaving the store entirely
        (release/abandon after the caller already took the value)."""
        if self.mode == "fp32" or not self.resid:
            return
        for s, l in zip(np.asarray(sh).tolist(), np.asarray(sl).tolist()):
            self.resid.pop((s, l), None)

    def add_at(self, sh: np.ndarray, sl: np.ndarray,
               rows: np.ndarray) -> None:
        """Additive merge on the authoritative cold rows; in-batch
        duplicates accumulate in batch order (np.add.at semantics on
        every mode — the fold runs on the duplicate-accumulated true
        values, so no update is lost below the grid)."""
        if self.mode == "fp32":
            np.add.at(self.q, (sh, sl), rows)
            return
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        pair = sh.astype(np.int64) * np.int64(self.main_slots) \
            + sl.astype(np.int64)
        upair, first, inv = np.unique(pair, return_index=True,
                                      return_inverse=True)
        ush, usl = sh[first], sl[first]
        true = self._true_rows(ush, usl, consume=True)
        np.add.at(true, inv, rows)
        self._store_rows(ush, usl, true)

    def set_at(self, sh: np.ndarray, sl: np.ndarray,
               rows: np.ndarray) -> None:
        """Overwrite rows (set / demote / relocation landing): prior
        residuals are discarded — a set REPLACES the sum — and the new
        sub-grid remainder parks."""
        if self.mode == "fp32":
            self.q[sh, sl] = rows
            return
        self._store_rows(sh, sl,
                         np.ascontiguousarray(rows, dtype=np.float32))

    def wire(self, sh: np.ndarray, sl: np.ndarray
             ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Stored wire rows (+ scales) for the dequant-fused device
        gather — what a transport would ship for these rows."""
        return (self.q[sh, sl],
                self.scale[sh, sl] if self.scale is not None else None)

    def promote_wire(self, shard: int, slots: np.ndarray):
        """Promotion payload for `slots` of `shard`: (wire rows, scales
        or None, fixup positions, fixup f32 rows). Rows with a parked
        residual are listed as fixups carrying their full-precision
        value (deq + residual, residual consumed) — the promotion
        scatter uploads the wire rows fused with the dequant, then
        overwrites the (few) fixup rows exactly (tier/promote.py)."""
        q = self.q[shard, slots]
        s = self.scale[shard, slots] if self.scale is not None else None
        fix_pos = []
        fix_vals = []
        if self.mode != "fp32" and self.resid:
            for i, l in enumerate(slots.tolist()):
                r = self.resid.pop((shard, l), None)
                if r is not None:
                    fix_pos.append(i)
                    fix_vals.append(
                        dequantize_rows(
                            self.mode, q[i],
                            s[i] if s is not None else None) + r)
        fp = np.asarray(fix_pos, dtype=np.int64)
        fv = (np.stack(fix_vals).astype(np.float32) if fix_vals
              else np.empty((0, self.value_length), np.float32))
        return q, s, fp, fv

    def full(self) -> np.ndarray:
        """The whole cold table, dequantized to f32 (checkpoint /
        full-table assembly — inherently a full-size materialization)."""
        if self.mode == "fp32":
            return self.q.copy()
        return dequantize_rows(self.mode, self.q, self.scale)

    def install_full(self, arr: np.ndarray) -> None:
        """Checkpoint restore: re-quantize the full table shard by
        shard (bounds the transient to one shard of f32 temporaries)
        and drop all residuals — idempotent for values already on the
        grid, so a save/restore round trip of a quantized store is
        value-stable."""
        assert arr.shape == self.q.shape, (
            f"main table geometry mismatch: checkpoint {arr.shape} vs "
            f"cold store {self.q.shape}")
        if self.mode == "fp32":
            self.q[:] = np.asarray(arr, dtype=np.float32)
            return
        self.resid.clear()
        for s in range(self.num_shards):
            q, sc = quantize_rows(
                self.mode, np.asarray(arr[s], dtype=np.float32))
            self.q[s] = q
            if self.scale is not None:
                self.scale[s] = sc
