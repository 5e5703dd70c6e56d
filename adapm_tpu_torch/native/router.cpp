// Native host-side runtime core.
//
// The reference's hot host path is C++ (per-key routing through the
// Addressbook + handle locks, addressbook.h:50-70, coloc_kv_worker.h:120-186).
// Here the device data plane runs on the GPU, but the *host* still resolves every
// key batch to pool coordinates before each fused step — that loop is this
// library. Compiled with g++ (no external deps), loaded via ctypes
// (adapm_tpu/native/__init__.py); a numpy fallback keeps pure-Python
// environments working.
//
// Contract notes:
//  - tables are the Addressbook's numpy arrays, accessed zero-copy.
//  - `oob` is the store's OOB sentinel: padding/masked entries are dropped
//    by device scatters and zero-filled by gathers.
//  - write_through mirrors Server._route: a Set must reach the owner, so a
//    local replica does not make the op local.

#include <cstdint>

extern "C" {

// Resolve routing for n keys (prefer a local replica, else the owner row).
// Outputs: o_sh/o_sl (owner shard + raw slot — callers mask the gather path
// themselves, since Set writes through to the owner even past a replica),
// c_sh/c_sl (replica coordinates; c_sl=oob where none), use_c mask.
// Returns the number of remote keys (not owned here, no local replica;
// write_through: replicas don't count as local).
// Returns the remote-key count, or -(i+1) if keys[i] is the first key
// outside [0, num_keys) (the caller raises; the numpy fallback would have
// raised IndexError, and unchecked table reads here would corrupt memory).
int64_t adapm_route(const int64_t* keys, int64_t n, int64_t num_keys,
                    const int32_t* owner, const int32_t* slot,
                    const int32_t* cache_slot_row,  // cache_slot[shard, :]
                    int32_t shard, int32_t oob, int32_t write_through,
                    int32_t* o_sh, int32_t* o_sl,
                    int32_t* c_sh, int32_t* c_sl, uint8_t* use_c,
                    uint8_t* local_mask /* out: for locality stats */) {
  int64_t n_remote = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = keys[i];
    if (k < 0 || k >= num_keys) return -(i + 1);
    const int32_t ow = owner[k];
    const int32_t cs = cache_slot_row[k];
    const bool replica = cs >= 0;
    o_sh[i] = ow;
    c_sh[i] = shard;
    use_c[i] = replica ? 1 : 0;
    o_sl[i] = slot[k];
    c_sl[i] = replica ? cs : oob;
    const bool on_owner = ow == shard;
    const bool local = write_through ? on_owner : (on_owner || replica);
    local_mask[i] = local ? 1 : 0;
    n_remote += local ? 0 : 1;
  }
  return n_remote;
}

// Locality counters: accesses[k] += 1; local_acc[k] += local[i]
// (the vectorized replacement for np.add.at, which is slow for large
// batches of duplicate keys). Out-of-range keys are skipped; returns the
// number skipped so the caller can raise.
int64_t adapm_count(const int64_t* keys, const uint8_t* local, int64_t n,
                    int64_t num_keys, int64_t* accesses,
                    int64_t* local_acc) {
  int64_t bad = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = keys[i];
    if (k < 0 || k >= num_keys) { ++bad; continue; }
    accesses[k] += 1;
    local_acc[k] += local[i];
  }
  return bad;
}

// Intent bookkeeping: intent_end[k] = max(intent_end[k], end) for a key
// batch (SyncManager._register's np.maximum.at). Returns skipped count.
// intent_end is int32 ([S, K] at 5M+ keys — int64 would double the
// footprint; clocks are bounded by CLOCK_MAX = 2^31-1).
int64_t adapm_intent_max(const int64_t* keys, int64_t n, int64_t num_keys,
                         int64_t end, int32_t* intent_end) {
  const int32_t e = end > 2147483647LL ? 2147483647 : (int32_t)end;
  int64_t bad = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = keys[i];
    if (k < 0 || k >= num_keys) { ++bad; continue; }
    if (intent_end[k] < e) intent_end[k] = e;
  }
  return bad;
}

// Replica expiry scan (legacy single-mask variant; superseded by
// adapm_replica_scan2 on the planner hot path but kept for tooling):
// for replica i at (key[i], shard[i]), keep iff
// intent_end[shard[i]*num_keys + key[i]] >= min_clock[shard[i]].
// Writes 1/0 into keep; returns number kept.
int64_t adapm_replica_scan(const int64_t* keys, const int32_t* shards,
                           int64_t n, const int32_t* intent_end,
                           const int64_t* min_clock, int64_t num_keys,
                           uint8_t* keep) {
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    const bool k =
        intent_end[(int64_t)shards[i] * num_keys + keys[i]] >=
        min_clock[shards[i]];
    keep[i] = k ? 1 : 0;
    kept += k ? 1 : 0;
  }
  return kept;
}

// Partitioned replica scan (SyncManager.sync_channel): one pass over a
// channel's (key, shard) snapshot emitting the four index partitions
// (keep/drop x local/cross) directly, instead of a keep-mask that
// Python re-walks. `cross` is the caller's owner-is-remote mask
// (snapshotted under the server lock; all-zero in a single process).
// Row indices land in the four caller-sized-n buffers; counts[4] =
// {keep_local, keep_cross, drop_local, drop_cross}.
void adapm_replica_scan2(const int64_t* keys, const int32_t* shards,
                         int64_t n, const int32_t* intent_end,
                         const int64_t* min_clock, int64_t num_keys,
                         const uint8_t* cross,
                         int64_t* keep_local, int64_t* keep_cross,
                         int64_t* drop_local, int64_t* drop_cross,
                         int64_t* counts) {
  int64_t nkl = 0, nkx = 0, ndl = 0, ndx = 0;
  for (int64_t i = 0; i < n; ++i) {
    const bool keep =
        intent_end[(int64_t)shards[i] * num_keys + keys[i]] >=
        min_clock[shards[i]];
    if (keep) {
      if (cross[i]) keep_cross[nkx++] = i; else keep_local[nkl++] = i;
    } else {
      if (cross[i]) drop_cross[ndx++] = i; else drop_local[ndl++] = i;
    }
  }
  counts[0] = nkl; counts[1] = nkx; counts[2] = ndl; counts[3] = ndx;
}

}  // extern "C"
