"""The collective exchange's transport: per-process receive slabs and one
put a exchange (the port's form of the all-to-all program the JAX
package compiles in `device/jaxport.py compile_collective`).

An exchange takes a list of `[P, ...]` host leaves, where `leaf[d]` is
the payload for process d, and returns same-shaped leaves where
`leaf[s]` is the payload process s sent here. EVERY process must call
it together, in the same order (the collective contract of
parallel/collective.py).

Each process owns one receive slab per leaf layout (the leaves' dtypes
and trailing shapes): `[2 parities][P sources][T bytes]`, T the packed
size of one destination's bucket (each leaf's region 16-byte aligned).
An exchange packs this process's leaves into one `[P, T]` buffer, and
K13 (`ops/kernels.py alltoall_put`) writes row d into process d's slab
at `[parity][self]` in ONE launch. The writer synchronizes its stream,
then every process meets at a store barrier, and only then reads its
own slab half.

Parity: exchange k writes parity k % 2. One slab with one barrier would
race (a fast writer's exchange k+1 could land before a slow reader has
copied exchange k out); with two, a writer reaches exchange k+2's write
only after exchange k+1's barrier, which every reader enters only after
it copied exchange k out.

On the card the slabs are raw `cudaMalloc` allocations (never torch's
caching allocator: `cudaIpcGetMemHandle` of a sub-allocation names its
base block and loses the offset). Their 64-byte IPC handles go round
through the control plane's store (`control._kv_gather`); each process
opens its peers' with `cudaIpcOpenMemHandle` at the layout's first
exchange and caches the mapping. A handle cannot be opened in its own
process, so the self bucket lands in the process's own slab directly (a
local copy in the same launch). `close()` unmaps every peer slab, meets
the others at one barrier, then frees its own. Any IPC or launch failure
raises: the card never falls back to the plain version.

On the CPU the slabs are `multiprocessing.shared_memory` segments whose
names go round the same way, and the put is K13's plain version
(`copy_` of each row): the same protocol, in real processes.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import control

_ALIGN = 16


def _round16(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class _Layout:
    """One leaf layout's packing (byte offset and size of each leaf's
    per-destination bucket) and its slabs."""

    def __init__(self, leaves: Sequence[np.ndarray], P: int):
        self.parts: List[Tuple[int, int, np.dtype, tuple]] = []
        off = 0
        for x in leaves:
            n = x[0].nbytes if x.shape[0] else 0
            self.parts.append((off, n, x.dtype, x.shape[1:]))
            off += _round16(n)
        self.T = max(off, _ALIGN)
        self.P = P
        self.own = None      # this process's slab (pointer or segment)
        self.peers: Dict[int, object] = {}   # mapped peer slabs
        self.views: List[torch.Tensor] = []  # flat uint8, one a process
        self.table = None    # [P] int64 device pointers (the card)

    def pack(self, leaves: Sequence[np.ndarray]) -> np.ndarray:
        buf = np.zeros((self.P, self.T), dtype=np.uint8)
        for (off, n, _, _), x in zip(self.parts, leaves):
            if n:
                buf[:, off:off + n] = x.reshape(self.P, -1).view(np.uint8)
        return buf

    def unpack(self, got: np.ndarray) -> List[np.ndarray]:
        out = []
        for off, n, dt, tail in self.parts:
            part = np.ascontiguousarray(got[:, off:off + n])
            out.append(part.view(dt).reshape((self.P,) + tuple(tail)))
        return out


class SlabExchange:
    """The exchange over `mesh` (parallel/mesh.py ProcessMesh): K13 on
    the card, its plain version over shared memory for a CPU device."""

    def __init__(self, mesh, site: str = "coll"):
        self.pid = int(mesh.pid)
        self.P = int(mesh.num_procs)
        self.device = torch.device(mesh.device)
        self.cuda = self.device.type == "cuda"
        self.site = site
        self._layouts: Dict[tuple, _Layout] = {}
        self._seq = 0
        self.closed = False
        self.bytes_put = 0    # bytes this process put (every bucket)

    # -- slabs ---------------------------------------------------------------

    def _open(self, lay: _Layout) -> None:
        """Allocate this process's slab for a new layout, trade names
        through the store, map the peers' (collective: every process
        meets each layout at the same exchange)."""
        nbytes = 2 * self.P * lay.T
        if self.cuda:
            from ..ops import kernels as K
            with torch.cuda.device(self.device):
                ptr, handle = K.slab_alloc(nbytes)
                lay.own = ptr
                names = control._kv_gather(f"{self.site}-slab", handle)
                ptrs = []
                for p, h in enumerate(names):
                    if p == self.pid:
                        ptrs.append(ptr)
                        continue
                    lay.peers[p] = K.slab_open(h)
                    ptrs.append(lay.peers[p])
            lay.views = [K.slab_view(q, nbytes) for q in ptrs]
            lay.table = torch.tensor(ptrs, dtype=torch.int64,
                                     device=self.device)
            return
        from multiprocessing import resource_tracker, shared_memory
        own = shared_memory.SharedMemory(create=True, size=nbytes)
        lay.own = own
        names = control._kv_gather(f"{self.site}-slab", own.name.encode())
        segs = []
        for p, nm in enumerate(names):
            if p == self.pid:
                segs.append(own)
                continue
            seg = shared_memory.SharedMemory(name=nm.decode())
            # the owner unlinks its segment; an attached one must not be
            # unlinked again by this process's tracker at exit
            resource_tracker.unregister(seg._name, "shared_memory")
            lay.peers[p] = seg
            segs.append(seg)
        lay.views = [torch.from_numpy(np.ndarray((nbytes,), np.uint8,
                                                 buffer=s.buf))
                     for s in segs]

    # -- the exchange --------------------------------------------------------

    def __call__(self, leaves: Sequence[np.ndarray]) -> List[np.ndarray]:
        if self.closed:
            raise RuntimeError("the collective exchange is closed")
        from ..ops import kernels as K
        P = self.P
        leaves = [np.ascontiguousarray(x) for x in leaves]
        for x in leaves:
            if x.ndim < 1 or x.shape[0] != P:
                raise ValueError(f"exchange leaves must be [P={P}, ...], "
                                 f"got {x.shape}")
        sig = tuple((x.dtype.str, x.shape[1:]) for x in leaves)
        lay = self._layouts.get(sig)
        if lay is None:
            lay = self._layouts[sig] = _Layout(leaves, P)
            self._open(lay)
        parity = self._seq % 2
        self._seq += 1
        half = parity * P * lay.T
        src = torch.from_numpy(lay.pack(leaves))
        if self.cuda:
            with torch.cuda.device(self.device):
                src = src.to(self.device)
                K.alltoall_put(src, lay.views, half + self.pid * lay.T,
                               lay.table)
                torch.cuda.current_stream(self.device).synchronize()
        else:
            K.alltoall_put(src, lay.views, half + self.pid * lay.T)
        self.bytes_put += P * lay.T
        # every process's puts of this exchange have landed past here
        control.barrier(f"{self.site}-x")
        mine = lay.views[self.pid][half:half + P * lay.T]
        got = mine.cpu().numpy() if self.cuda else mine.numpy().copy()
        return lay.unpack(got.reshape(P, lay.T))

    # -- teardown ------------------------------------------------------------

    def close(self) -> None:
        """Unmap every peer slab, meet the peers at one barrier (no
        process frees a slab another still maps), free this process's
        own. Collective; idempotent."""
        if self.closed:
            return
        self.closed = True
        if not self._layouts:
            return
        from ..ops import kernels as K
        for lay in self._layouts.values():
            lay.views, lay.table = [], None
        gc.collect()   # drop the shared-memory views' buffer exports
        for lay in self._layouts.values():
            for seg in lay.peers.values():
                if self.cuda:
                    K.slab_close(seg)
                else:
                    seg.close()
        control.barrier(f"{self.site}-close")
        for lay in self._layouts.values():
            if self.cuda:
                K.slab_free(lay.own)
            else:
                lay.own.close()
                lay.own.unlink()
        self._layouts.clear()
