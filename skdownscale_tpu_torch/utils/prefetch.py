"""Double-buffered host feed: overlap host work with device compute.

Host copy of ``skdownscale_tpu/utils/prefetch.py``.  The grid runner
alternates host stages (``pack_compact``, the host-to-device copy) with
device passes; :func:`prefetched` prepares item ``i+1`` on one worker thread
while the caller consumes item ``i`` (lookahead 1, so peak host memory holds
at most two prepared chunks).  One worker is deliberate: the C++ packer is
already multithreaded, and the thread exists to overlap with device time.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

__all__ = ["prefetched"]

T = TypeVar("T")
U = TypeVar("U")


def prefetched(items: Iterable[T], prep: Callable[[T], U]) -> Iterator[U]:
    """Yield ``prep(item)`` for each item, preparing the NEXT item on a
    worker thread while the caller consumes the current one.

    Exceptions raised by ``prep`` surface in the consumer at the failed
    item's position (``Future.result`` re-raises).  With zero or one item
    this degenerates to a plain map.
    """
    items = list(items)
    if not items:
        return
    if len(items) == 1:
        yield prep(items[0])
        return
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(prep, items[0])
        for nxt in items[1:]:
            cur = fut.result()
            fut = ex.submit(prep, nxt)
            yield cur
        yield fut.result()
