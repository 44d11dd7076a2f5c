"""glibc heap retention for GB-scale numpy churn.

A host that faults fresh anonymous pages at ~200 MB/s makes every
fresh GB-scale numpy allocation costs seconds of first-touch (measured:
5.4 s to fill a 1 GB matrix on fresh pages, 0.15 s on reused ones).
glibc's default tuning returns large blocks to the kernel on free
(mmap/munmap above 128 KB), so the per-chain pipeline re-faulted the
same working set at every stage.  Raising M_TRIM_THRESHOLD and
M_MMAP_THRESHOLD to the maximum keeps freed blocks in the brk heap,
where the pages stay faulted and later allocations reuse them.

Cost: the process's RSS stays at its high-water mark.  No-op on non-glibc platforms.
"""

from __future__ import annotations

_done = False


def retain_freed_heap() -> bool:
    global _done
    if _done:
        return True
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6")
        big = ctypes.c_int(2 ** 31 - 1)
        ok = (libc.mallopt(-1, big) == 1        # M_TRIM_THRESHOLD
              and libc.mallopt(-3, big) == 1)   # M_MMAP_THRESHOLD
        _done = bool(ok)
        return _done
    except Exception:
        return False
