"""Threaded prefetching over an indexable dataset (port of
``data/prefetch.py``): the counterpart of the reference's
``DataLoader(num_workers=N)`` (``bayesian_active_learning_imagenet.py:405-415``;
``args.py`` exposes ``--workers/-j``).

JPEG decode and resize/normalize are a real-data sweep's host cost. A thread
pool serves it: PIL decode and numpy release the GIL for the heavy parts,
and the consumer (the sweep) wants items in order with bounded memory.
``prefetch(dataset, num_workers, buffer)`` keeps up to ``buffer``
``dataset[i]`` calls in flight and yields results in index order.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence


def prefetch(dataset, num_workers: int = 4, buffer: int = 16,
             indices: Sequence[int] = None) -> Iterator:
    """Yield ``dataset[i]`` for each index, decoded ahead by worker threads.

    Args:
      dataset: indexable (``__len__`` + ``__getitem__``). Plain iterables
        are yielded through unchanged (they cannot be read ahead safely).
      num_workers: decoding threads; ``0`` disables prefetching.
      buffer: max in-flight items (bounds memory at about ``buffer`` decoded
        images).
      indices: optional explicit index order; defaults to
        ``range(len(dataset))``.

    An exception raised by ``dataset[i]`` propagates at the yield point of
    that index, in order, as it would serially.
    """
    if num_workers <= 0 or not hasattr(dataset, "__getitem__"):
        if indices is not None:
            for i in indices:
                yield dataset[i]
        elif hasattr(dataset, "__getitem__"):
            # An explicit range: the legacy __getitem__ protocol would spin
            # forever on a dataset that does not raise IndexError.
            for i in range(len(dataset)):
                yield dataset[i]
        else:
            yield from dataset
        return

    order = list(indices) if indices is not None else list(range(len(dataset)))
    buffer = max(int(buffer), 1)

    with ThreadPoolExecutor(max_workers=int(num_workers)) as pool:
        futures = {}
        next_submit = 0

        def top_up():
            nonlocal next_submit
            while next_submit < len(order) and len(futures) < buffer:
                futures[next_submit] = pool.submit(dataset.__getitem__, order[next_submit])
                next_submit += 1

        top_up()
        for pos in range(len(order)):
            fut = futures.pop(pos)
            try:
                item = fut.result()
            except BaseException:
                # Drop the queue on a fatal error; what already runs finishes.
                for f in futures.values():
                    f.cancel()
                raise
            top_up()
            yield item
