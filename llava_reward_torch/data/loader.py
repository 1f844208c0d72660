"""Prefetching data loader (the port's own copy of
``llava_reward_tpu/data/loader.py``): a thread pool decodes and processes
images a few batches ahead, a producer thread collates them (and, given
``device_put``, moves them to the card), and the consumer takes finished
batches from a bounded queue, so host work overlaps the card's.

The threads end with the iteration: when it is exhausted, when the consumer
stops early (the generator is closed) and when a worker raises (the error
reaches the consumer). Queued work is cancelled and the threads are joined
before the generator returns.

Spans (``utils/profiling``): ``loader.wait`` on the consumer, once a batch;
``loader.decode_wait``, ``loader.collate`` and ``loader.device_put`` on the
producer.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional

from ..utils.profiling import span


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        sampler: Iterable[int],
        batch_size: int,
        collate_fn: Callable,  # (items) -> host batch
        num_workers: int = 8,
        prefetch_batches: int = 2,
        device_put: Optional[Callable] = None,  # host batch -> device batch
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches
        self.device_put = device_put
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.sampler)  # type: ignore[arg-type]
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        indices = list(self.sampler)
        batches = [indices[i : i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        pool = ThreadPoolExecutor(self.num_workers, thread_name_prefix="PrefetchLoader-worker")

        def put_or_stop(msg) -> bool:
            """A timed put that re-checks ``stop``, so a consumer that left
            never leaves the producer blocked on the full queue."""
            while not stop.is_set():
                try:
                    out_q.put(msg, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def submit(b):
            return [pool.submit(self.dataset.__getitem__, i) for i in b]

        def produce():
            try:
                ahead = self.prefetch_batches + 1  # item futures a batch ahead
                futures = [submit(b) for b in batches[:ahead]]
                for bi in range(len(batches)):
                    if stop.is_set():
                        return
                    with span("loader.decode_wait"):
                        items = [f.result() for f in futures[bi]]
                    futures[bi] = None
                    if bi + ahead < len(batches):
                        futures.append(submit(batches[bi + ahead]))
                    with span("loader.collate"):
                        batch = self.collate_fn(items)
                    if self.device_put:
                        with span("loader.device_put"):
                            batch = self.device_put(batch)
                    if not put_or_stop(("item", batch)):
                        return
            except Exception as e:  # a worker's or the collator's error
                put_or_stop(("error", e))

        producer = threading.Thread(target=produce, name="PrefetchLoader-producer",
                                    daemon=True)
        producer.start()
        try:
            for _ in batches:
                with span("loader.wait"):
                    kind, val = out_q.get()
                if kind == "error":
                    raise val
                yield val
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
            producer.join()
            pool.shutdown(wait=True)
