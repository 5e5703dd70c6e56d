"""Multi-process control plane (the JAX package's `parallel/control.py`).

Replaces the reference's scheduler + Van control machinery (ADD_NODE
rendezvous, BARRIER counting, heartbeats — src/van.cc:40-210,
src/postoffice.cc:149-187) with a `torch.distributed.TCPStore`: process
0 hosts the store at `ADAPM_COORDINATOR`, and its set / blocking get /
add / wait replace the JAX coordinator's key-value calls one for one.
Process ranks replace node ids. No process group is built: NCCL refuses
two ranks on one GPU, and the data plane rides the DCN channel
(parallel/dcn.py), not collectives.

All primitives degrade to no-ops / local computation in a single-process
run, so the same app code runs in one process or many.

`allreduce` replaces the reference's PS-based scalar/vector allreduce
(`ps_allreduce`, include/utils.h:163-197) used by the apps for loss/eval
aggregation: every rank publishes its dtype/shape-framed payload under a
per-site sequence key, reads every rank's, and reduces the float64 rows
in rank order — the JAX control plane's gather-by-key, so the results
are bitwise its results.
"""
from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Optional

import numpy as np

# env names of the launcher contract (launcher.py), mirroring the
# reference's DMLC_* topology env vars (docs/env.md)
ENV_COORD = "ADAPM_COORDINATOR"       # host:port of process 0's store
ENV_NUM_PROCS = "ADAPM_NUM_PROCESSES"
ENV_PROC_ID = "ADAPM_PROCESS_ID"

# generous default wait: a peer may be inside a kernel build or a long
# device phase when another reaches a barrier
_TIMEOUT_S = 600.0

_store = None
_addr = None
_num = 1
_pid = 0
_init_lock = threading.Lock()


def _connect(host: str, port: int, master: bool):
    from torch.distributed import TCPStore
    return TCPStore(host, port, world_size=_num, is_master=master,
                    timeout=datetime.timedelta(seconds=_TIMEOUT_S),
                    wait_for_workers=False)


def new_client():
    """A client connection of its own to the control plane's store. A
    TCPStore client runs one operation at a time, and a blocking wait
    (a barrier's) holds it: a thread that must not wait behind another
    (a channel resolving a peer's address to send a reply, the
    heartbeat) takes its own connection."""
    _client()
    return _connect(*_addr, master=False)


def init_from_env() -> bool:
    """Join the multi-process runtime from the launcher env; returns True
    if one was set up (reference Postoffice::Start + Van ADD_NODE
    handshake, collapsed into one call). Process 0 hosts the TCPStore;
    every process connects and waits at an `init` barrier for all the
    others. Idempotent."""
    global _store, _addr, _num, _pid
    coord = os.environ.get(ENV_COORD)
    if not coord:
        return False
    n = int(os.environ[ENV_NUM_PROCS])
    pid = int(os.environ[ENV_PROC_ID])
    if n <= 1:
        return False
    with _init_lock:
        if _store is not None:
            return True
        host, port = coord.rsplit(":", 1)
        _num, _pid = n, pid
        _addr = (host, int(port))
        _store = _connect(host, int(port), master=pid == 0)
    barrier("init")
    return True


def _ensure() -> None:
    """A launched rank joins on first use, so a caller that asks for the
    rank or the world size before `setup` gets the launched answer."""
    if _store is None and int(os.environ.get(ENV_NUM_PROCS, "1")
                              or "1") > 1:
        init_from_env()


def num_processes() -> int:
    _ensure()
    return _num


def process_id() -> int:
    _ensure()
    return _pid


# -- the store surface (the rendezvous of parallel/dcn.py, net/socket.py) ---


def _client():
    _ensure()
    if _store is None:
        raise RuntimeError("the multi-process control plane is not "
                           "initialized (launch through "
                           "adapm_tpu_torch.launcher)")
    return _store


def _get_bytes(key: str, timeout_s: float = _TIMEOUT_S) -> bytes:
    st = _client()
    st.wait([key], datetime.timedelta(seconds=timeout_s))
    return st.get(key)


def _delete(key: str) -> None:
    try:
        _client().delete_key(key)
    except Exception:  # noqa: BLE001 — hygiene only; a kept key is harmless
        pass


_barrier_lock = threading.Lock()


def barrier(name: str = "adapm") -> None:
    """Global process barrier (reference Postoffice::Barrier via the
    scheduler, src/postoffice.cc:149-174): an `add` on the barrier's
    sequence key, and a wait for its `done` key, which the last arrival
    sets. No device work, so it is safe from background threads while
    kernels run.

    Ordering contract: barriers of the SAME `name` must be invoked in
    the same order on every process (sequence ids are per name, so
    differently-named barriers interleaved differently across ranks
    still pair correctly). Same-name barriers from two local threads
    racing each other remain undefined — one caller thread per name.

    Wait time is observed into the `collective.barrier_wait_s`
    histogram of the process-default metrics registry."""
    if num_processes() == 1:
        return
    from ..obs.metrics import timed
    with timed("collective.barrier_wait_s"):
        seq = _next_seq(f"barrier/{name}")
        key = f"adapm/{name}/{seq}"
        st = _client()
        if st.add(key, 1) == _num:
            st.set(key + "/done", "1")
        st.wait([key + "/done"], datetime.timedelta(seconds=_TIMEOUT_S))
        if _pid == 0 and seq > 1:
            # every rank passed the previous generation before anyone
            # could pass this one: its keys are free
            prev = f"adapm/{name}/{seq - 1}"
            _delete(prev)
            _delete(prev + "/done")


_hb_stop: Optional[threading.Event] = None


def start_heartbeat(interval_s: float = 2.0) -> None:
    """Publish a periodic liveness beat to the store (reference Van
    heartbeats, src/van.cc:515-527; off by default there and opt-in
    here). No-op in a single process."""
    global _hb_stop
    if num_processes() == 1 or _hb_stop is not None:
        return
    st = new_client()   # never behind a barrier's wait
    pid = _pid
    stop = threading.Event()
    _hb_stop = stop

    def loop():
        while True:
            try:
                st.set(f"adapm/hb/{pid}", str(time.time()))
            except Exception:  # noqa: BLE001 — store gone at teardown
                return
            if stop.wait(interval_s):
                return

    # process-level heartbeat with no Server (hence no executor) in
    # scope: the control plane outlives and predates any Server
    threading.Thread(target=loop, daemon=True,
                     name="adapm-heartbeat").start()


def stop_heartbeat() -> None:
    global _hb_stop
    if _hb_stop is not None:
        _hb_stop.set()
        _hb_stop = None


def dead_processes(max_age_s: float = 10.0) -> list:
    """Process ids whose last heartbeat is older than `max_age_s` (the
    reference's Postoffice::GetDeadNodes, src/postoffice.cc:202-221).
    Processes that never published a beat are not reported (heartbeats
    are opt-in, as in the reference). Empty in a single process."""
    if num_processes() == 1:
        return []
    st = _client()
    now = time.time()
    dead = []
    for p in range(_num):
        if p == _pid:
            continue
        key = f"adapm/hb/{p}"
        if not st.check([key]):
            continue
        if now - float(st.get(key).decode()) > max_age_s:
            dead.append(p)
    return dead


_seqs: dict = {}
_inflight: set = set()


def _next_seq(counter: str) -> int:
    """Allocate the next sequence number for `counter`. Per-name
    counters: the calling-site tag is part of every store key and
    barrier id, so two DIFFERENT sites invoked in different orders on
    different ranks still pair correctly instead of cross-wiring each
    other's keys into a timeout."""
    with _barrier_lock:
        _seqs[counter] = _seqs.get(counter, 0) + 1
        return _seqs[counter]


class _exclusive:
    """Immediate-error guard for the single-caller-thread contract: two
    local threads driving the same collective site concurrently would
    interleave sequence allocation differently across ranks — a
    cross-wire that would surface as a timeout. Raise at the second
    local entry instead."""

    def __init__(self, site: str):
        self.site = site

    def __enter__(self):
        with _barrier_lock:
            if self.site in _inflight:
                raise RuntimeError(
                    f"concurrent collective call on site {self.site!r}: "
                    "allreduce/broadcast/_kv_gather are single-caller-"
                    "thread per site — give each calling site its own "
                    "`site` tag, or serialize the callers")
            _inflight.add(self.site)
        return self

    def __exit__(self, *exc):
        with _barrier_lock:
            _inflight.discard(self.site)


def _pack_array(arr: np.ndarray) -> bytes:
    """Frame an array payload with its dtype/shape so the receiver can
    verify instead of reinterpreting bytes (a root/non-root template
    mismatch with coincidentally equal nbytes — e.g. int64 vs float64 —
    would otherwise decode garbage). ':' separators on purpose:
    dtype.str itself BEGINS with '|' for byte-order-free dtypes (bool,
    uint8, bytes), so '|' cannot delimit it."""
    head = f"{arr.dtype.str}:{','.join(map(str, arr.shape))}:"
    return head.encode() + arr.tobytes()


def _unpack_array(raw: bytes, expect: np.ndarray,
                  what: str) -> np.ndarray:
    """Decode a _pack_array payload, failing loudly on any dtype/shape/
    size mismatch against the receiver's template."""
    sep1 = raw.index(b":")
    sep2 = raw.index(b":", sep1 + 1)
    dt = np.dtype(raw[:sep1].decode())
    shape_s = raw[sep1 + 1:sep2].decode()
    shape = tuple(int(x) for x in shape_s.split(",")) if shape_s else ()
    if dt != expect.dtype or shape != expect.shape:
        raise ValueError(
            f"{what}: payload is {dt}{list(shape)} but this rank's "
            f"template is {expect.dtype}{list(expect.shape)} — ranks "
            "disagree on the collective's array layout")
    body = raw[sep2 + 1:]
    if len(body) != expect.nbytes:
        raise ValueError(
            f"{what}: payload carries {len(body)} bytes for a "
            f"{expect.nbytes}-byte template")
    # .copy(): frombuffer over bytes is read-only; callers may mutate
    return np.frombuffer(body, dtype=dt).reshape(shape).copy()


def _kv_gather(tag: str, payload: bytes):
    """Publish this rank's payload under a fresh sequence id and collect
    every rank's, through the store. Host-only on purpose: a device
    collective here could deadlock the PM (a rank parked inside it
    cannot serve the device gather a peer's in-flight read needs).

    Contract: ONE caller thread per `tag`, invoking in the same order on
    every process; a second local thread entering the same tag raises
    (_exclusive). Keys are deleted after a trailing barrier so the store
    does not grow with call count."""
    with _exclusive(f"kv/{tag}"):
        seq = _next_seq(f"kv/{tag}")
        key = f"adapm/{tag}/{seq}"
        _client().set(f"{key}/{_pid}", payload)
        parts = [_get_bytes(f"{key}/{p}") for p in range(_num)]
        # all ranks have read everything once all have passed this
        # barrier; deleting one's own key is then race-free
        barrier(f"{tag}-gc")
        _delete(f"{key}/{_pid}")
        return parts


def allreduce(values, op: str = "sum", site: str = "ar") -> np.ndarray:
    """Sum/mean/max a host scalar or vector across processes (reference
    ps_allreduce, include/utils.h:163-197: push to a shared PS key,
    barrier, pull). Single process: the input as a float64 array.

    Contract: ONE caller thread per `site`, same per-site call order on
    every process (see _kv_gather). Payloads are dtype/shape-framed, so
    ranks disagreeing on the array layout fail loudly."""
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"unknown allreduce op {op}")
    arr = np.atleast_1d(np.asarray(values, dtype=np.float64))
    if num_processes() == 1:
        return arr
    from ..obs.metrics import timed
    with timed("collective.allreduce_wait_s"):
        parts = _kv_gather(site, _pack_array(arr))
        gathered = np.stack([
            _unpack_array(b, arr, f"allreduce[{site}] rank {p}")
            for p, b in enumerate(parts)])
    return {"sum": gathered.sum, "mean": gathered.mean,
            "max": gathered.max}[op](axis=0)


def broadcast(values, root: int = 0, site: str = "bc") -> np.ndarray:
    """Broadcast a host array from `root` to all processes (worker-0
    initialization across processes), through one root-published store
    key; same single-caller-thread-per-site contract as allreduce. The
    payload carries the root's dtype/shape, so a template mismatch
    raises."""
    arr = np.asarray(values)
    if num_processes() == 1:
        return arr
    with _exclusive(f"kv/{site}"):
        seq = _next_seq(f"kv/{site}")
        key = f"adapm/{site}/{seq}"
        if _pid == root:
            _client().set(key, _pack_array(arr))
        raw = _get_bytes(key)
        barrier(f"{site}-gc")
        if _pid == root:
            _delete(key)
    return _unpack_array(raw, arr, f"broadcast[{site}]")
