"""PyTorch/NumPy bindings: the reference's `adapm` Python module surface
(bindings/bindings.cc) so external apps (e.g. the GCN/CTR PyTorch apps,
README.md:23) can switch backends without code changes. The JAX
package's `bindings.py` over the port's Server: its parameters live on
`cuda` unless `Server(..., device="cpu")` says otherwise; the values
that callers pass and receive are host arrays either way.

Surface parity (bindings.cc):
  setup(num_keys, num_threads, use_techniques="", num_channels=-1)
  scheduler(num_keys, num_threads)            -- no-op here (no scheduler
                                                 process)
  Server(num_keys_or_value_lengths, device=None)
    .enable_sampling_support(scheme, with_replacement, distribution, min, max)
    .barrier() / .shutdown() / .my_rank()
  Worker(customer_id, server)
    .pull/.push/.set(keys, vals, async=False) -> ts   (in-place into vals)
    .intent(keys, start, end=0)
    .prepare_sample(K, start, end=0) / .pull_sample(id, keys, vals, async)
    .wait(ts) / .waitall() / .wait_sync() / .advance_clock()
    .current_clock / .begin_setup / .end_setup / .barrier / .finalize
    .get_key_size(key) / .num_keys

Both torch.Tensor (CPU) and numpy arrays are accepted; results are written
in place through a zero-copy numpy view of the tensor's memory (the
reference writes through data_ptr). Value-length and key-range validation
mirror assert_correct_value_length / assert_keys_in_range (bindings.cc:38-61)
including the error messages' intent. Built-in sampling distributions:
uniform and log-uniform over [min, max) (bindings.cc:64-78).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from .base import LOCAL
from .config import SystemOptions
from .core import kv as _kv
from .device.context import make_context

_global_opts: Optional[SystemOptions] = None


def _as_numpy(x) -> np.ndarray:
    """Zero-copy view of a torch CPU tensor or numpy array."""
    if hasattr(x, "detach") and hasattr(x, "numpy"):  # torch.Tensor
        return x.detach().numpy()
    return np.asarray(x)


def setup(num_keys: int, num_threads: int, use_techniques: str = "",
          num_channels: int = -1) -> None:
    """Record global PM options (reference bindings.cc setup: techniques and
    channel count are process-wide, applied to Servers constructed later).
    Under the launcher this also joins the multi-process runtime — the
    reference's ps::Setup -> Postoffice::Start."""
    from .parallel import control
    control.init_from_env()
    global _global_opts
    from .base import MgmtTechniques
    opts = SystemOptions()
    if use_techniques:
        opts.techniques = MgmtTechniques(use_techniques)
    if num_channels != -1:
        opts.channels = num_channels
    opts.sync_max_per_sec = 0.0  # bindings drive sync via wait_sync/barrier
    opts.bindings_num_workers = num_threads  # type: ignore[attr-defined]
    _global_opts = opts


def scheduler(num_keys: int, num_threads: int) -> None:
    """Reference: runs the scheduler role. The port has no scheduler
    process, so this returns immediately — kept so launch scripts port
    unchanged."""


class Server:
    """Reference ServerT binding (bindings.cc Server class), on `device`
    (default cuda)."""

    def __init__(self, value_lengths: Union[int, np.ndarray, "object"],
                 num_keys: Optional[int] = None, device=None):
        opts = _global_opts or SystemOptions(sync_max_per_sec=0.0)
        nw = getattr(opts, "bindings_num_workers", None)
        if np.ndim(value_lengths) == 0 and num_keys is None:
            # ServerT(int): uniform length for the setup()-declared key count
            raise TypeError(
                "Server(uniform_len) needs num_keys: use "
                "Server(value_length, num_keys) or pass a per-key array")
        if np.ndim(value_lengths) == 0:
            lens: Union[int, np.ndarray] = int(value_lengths)
            nk = int(num_keys)
        else:
            lens = _as_numpy(value_lengths).astype(np.int64)
            nk = len(lens)
        self._srv = _kv.Server(nk, lens, opts=opts,
                               ctx=make_context(None, device),
                               num_workers=nw)

    def enable_sampling_support(self, scheme: str, with_replacement: bool,
                                distribution: str, min: int, max: int
                                ) -> None:  # noqa: A002 (reference names)
        opts = self._srv.opts
        opts.sampling_scheme = scheme
        opts.sampling_with_replacement = bool(with_replacement)
        lo, hi = int(min), int(max)
        if distribution == "uniform":
            def fn(n, rng):
                return rng.integers(lo, hi, n).astype(np.int64)
        elif distribution == "log-uniform":
            def fn(n, rng):
                u = rng.random(n)
                return (np.exp(u * np.log(hi - lo + 1)) + lo - 1
                        ).astype(np.int64)
        else:
            raise ValueError(
                f"Unknown sampling distribution '{distribution}'")
        self._srv.enable_sampling_support(fn, lo, hi)

    def barrier(self) -> None:
        self._srv.barrier()

    def shutdown(self) -> None:
        self._srv.shutdown()

    def my_rank(self) -> int:
        from .parallel import control
        return control.process_id()


class Worker:
    """Reference WorkerT binding: ops write results into the caller's
    buffer, async ops return a timestamp for wait()."""

    def __init__(self, customer_id: int, server: Server):
        self._server = server
        self._w = server._srv.make_worker(customer_id)

    # -- validation (bindings.cc:38-61) --------------------------------------

    def _check(self, keys: np.ndarray, vals: Optional[np.ndarray]) -> None:
        srv = self._server._srv
        if len(keys) and (keys.min() < 0 or keys.max() >= srv.num_keys):
            bad = keys[(keys < 0) | (keys >= srv.num_keys)][0]
            raise IndexError(
                f"At least one of the provided keys ({bad}) is outside the "
                f"key range [0, {srv.num_keys})")
        if vals is not None:
            needed = int(srv.value_lengths[keys].sum())
            if vals.size != needed:
                raise ValueError(
                    "The provided value array does not match the size "
                    f"specified in the parameter server: {vals.size} != "
                    f"{needed}")

    def _kv(self, keys, vals):
        k = _as_numpy(keys).astype(np.int64, copy=False).ravel()
        v = _as_numpy(vals)
        if not v.flags["C_CONTIGUOUS"]:
            # reshape(-1) on a non-contiguous view would copy, silently
            # breaking the in-place fill contract
            raise ValueError(
                "value buffer must be contiguous (got a strided view; "
                "call .contiguous() / np.ascontiguousarray first)")
        self._check(k, v)
        return k, v

    # -- data plane ----------------------------------------------------------

    def pull(self, keys, vals, asynchronous: bool = False) -> int:
        k, v = self._kv(keys, vals)
        flat = v.reshape(-1)
        ts = self._w.pull(k, out=flat)
        if not asynchronous and ts != LOCAL:
            self._w.wait(ts)
        return ts

    def push(self, keys, vals, asynchronous: bool = False) -> int:
        k, v = self._kv(keys, vals)
        ts = self._w.push(k, v.reshape(-1))
        if not asynchronous and ts != LOCAL:
            self._w.wait(ts)
        return ts

    def set(self, keys, vals, asynchronous: bool = False) -> int:
        k, v = self._kv(keys, vals)
        ts = self._w.set(k, v.reshape(-1))
        if not asynchronous and ts != LOCAL:
            self._w.wait(ts)
        return ts

    # -- intent / clock ------------------------------------------------------

    def intent(self, keys, start: int, end: int = 0) -> None:
        k = _as_numpy(keys).astype(np.int64, copy=False).ravel()
        self._check(k, None)
        self._w.intent(k, start, end if end else None)

    def advance_clock(self) -> int:
        return self._w.advance_clock()

    @property
    def current_clock(self) -> int:
        return self._w.current_clock

    # -- sampling ------------------------------------------------------------

    def prepare_sample(self, K: int, start: int, end: int = 0) -> int:
        return self._w.prepare_sample(K, start, end if end else None)

    def pull_sample(self, sample_id: int, keys, vals,
                    asynchronous: bool = False) -> int:
        """Draw samples into `keys` and their values into `vals`. Mirrors
        bindings.cc:330-337: returns the underlying pull's timestamp (-1
        when every sampled key was local, e.g. the Local scheme by
        construction); asynchronous=True skips the wait — `vals` is filled
        when the caller waits on the returned timestamp."""
        k = _as_numpy(keys)
        if not k.flags["C_CONTIGUOUS"]:
            raise ValueError("pull_sample key buffer must be contiguous")
        drawn = self._w.pull_sample_keys(sample_id, len(k))
        k.ravel()[:] = drawn
        # the value fetch is an ordinary pull of the drawn keys: shared
        # validation + out= fill + async contract
        return self.pull(drawn, vals, asynchronous)

    # -- waiting / lifecycle -------------------------------------------------

    def wait(self, ts: int) -> None:
        self._w.wait(ts)

    def waitall(self) -> None:
        self._w.wait_all()

    def wait_sync(self) -> None:
        self._w.wait_sync()

    def barrier(self) -> None:
        self._w.barrier()

    def begin_setup(self) -> None:
        self._w.begin_setup()

    def end_setup(self) -> None:
        self._w.end_setup()

    def finalize(self) -> None:
        self._w.finalize()

    def get_key_size(self, key_id: int = 0) -> int:
        return int(self._server._srv.value_lengths[key_id])

    @property
    def num_keys(self) -> int:
        return self._server._srv.num_keys
