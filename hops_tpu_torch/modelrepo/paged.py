"""Block-pool accounting for the paged KV cache (counterpart of
``hops_tpu/modelrepo/paged.py``, a copy: the module imports no JAX, and
the port imports nothing of the JAX package).

The device side of paging lives in ``models/transformer.py``
(:class:`~hops_tpu_torch.models.transformer.PagedKVCache`: per-layer
block pools addressed through one page table) and ``ops/attention.py``
(``paged_decode_attention``: the kernels read each key through the
table). THIS module is the host side: which physical blocks are free,
which are live, and how many requests reference each — the bookkeeping
the engine consults before every dispatch.

Reference counting makes prefix caching a page-table trick instead of a
cache copy: a registered prefix's full blocks are held by the registry
(one ref) and by every live request that shares them (one ref each); a
request's private blocks simply have refcount 1. Freeing is uniform —
drop one ref, release the block when it hits zero. (The port's engine
has no prefixes yet, so every block it allocates has refcount 1.)

Block 0 is reserved as the SCRATCH block: free rows (all-zero page
table) and pad garbage land there, and the attention mask makes it
unreachable — the paged twin of the dense engine's "free rows clamp idx
to 0" convention.
"""

from __future__ import annotations

import collections
import threading


class BlockPoolExhausted(RuntimeError):
    """No free block: callers queue the admission or preempt a slot."""


class BlockPool:
    """Refcounted free-list over ``num_blocks`` physical cache blocks.

    Thread-safe: the engine itself is single-threaded, but serving
    surfaces (stats) read utilization concurrently with the serving
    thread's alloc/free traffic.
    """

    def __init__(self, num_blocks: int, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(
                f"pool needs > {reserved} blocks (block 0..{reserved - 1} "
                f"reserved), got {num_blocks}"
            )
        self.num_blocks = num_blocks
        self.reserved = reserved
        self._lock = threading.Lock()
        # Free physical block ids, FIFO so freshly freed blocks rest
        # before reuse (easier to spot use-after-free in tests).
        self._free: collections.deque[int] = collections.deque(
            range(reserved, num_blocks)
        )  # guarded by: self._lock
        # Live refcounts per physical block. # guarded by: self._lock
        self._refs: dict[int, int] = {}
        self._peak_used = 0  # guarded by: self._lock

    # -- queries ---------------------------------------------------------

    @property
    def total(self) -> int:
        """Allocatable blocks (the reserved scratch blocks excluded)."""
        return self.num_blocks - self.reserved

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used(self) -> int:
        with self._lock:
            return len(self._refs)

    @property
    def peak_used(self) -> int:
        with self._lock:
            return self._peak_used

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._refs.get(block, 0)

    def stats(self) -> dict[str, float | int]:
        with self._lock:
            used = len(self._refs)
            total = self.num_blocks - self.reserved
            return {
                "blocks_total": total,
                "blocks_used": used,
                "blocks_peak_used": self._peak_used,
                "utilization": used / total if total else 0.0,
            }

    # -- mutation --------------------------------------------------------

    def alloc(self, n: int) -> list[int]:
        """``n`` fresh blocks at refcount 1, or :class:`BlockPoolExhausted`
        with nothing allocated (all-or-nothing, so a failed admission
        never leaks a partial allocation)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        with self._lock:
            if n > len(self._free):
                raise BlockPoolExhausted(
                    f"need {n} blocks, {len(self._free)} free of "
                    f"{self.num_blocks - self.reserved}"
                )
            out = [self._free.popleft() for _ in range(n)]
            for b in out:
                self._refs[b] = 1
            self._peak_used = max(self._peak_used, len(self._refs))
            return out

    def ref(self, block: int) -> None:
        """One more reader of a live block (page-table sharing)."""
        with self._lock:
            if block not in self._refs:
                raise ValueError(f"ref of unallocated block {block}")
            self._refs[block] += 1

    def unref(self, block: int) -> bool:
        """Drop one reference; release the block to the free list when
        the last reader is gone. Returns whether it was released."""
        with self._lock:
            rc = self._refs.get(block)
            if rc is None:
                raise ValueError(f"unref of unallocated block {block}")
            if rc > 1:
                self._refs[block] = rc - 1
                return False
            del self._refs[block]
            self._free.append(block)
            return True

    def unref_all(self, blocks: list[int]) -> int:
        """Drop one ref from each of ``blocks`` (a finished or preempted
        slot's page list); returns how many were actually released."""
        return sum(self.unref(b) for b in blocks)
