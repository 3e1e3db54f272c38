"""Input pipeline: per-process sharding, host prefetch, and the
host-to-card copy one batch ahead.

The port's copy of the JAX package's ``data/pipeline.py``: a background
thread assembles batch N+1 (text and mel extraction, padding) while the
card runs batch N. With several training processes each takes a strided
slice of the dataset (torch's DistributedSampler); the index and count come
from ``torch.distributed`` when it is initialised. ``DeviceTransfer``
copies each batch to the card from pinned host memory on a side stream,
and makes the consumer's stream wait for that copy.

The JAX package extracts items in a pool of worker threads. The port does
not: its step loop is host-bound at small batches (it launches thousands of
small kernels a step), and extraction beside it slows it. With 8 extraction
threads a B=32 step of ``Trainer.fit`` took 327-403 ms against 86-91 ms on
a resident batch (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6). The
dataset also keeps the mels it computes (``TextMelDataset``), so only a
corpus's first epoch pays for extraction.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.data.bucketing import BucketSampler, pad_batch
from tacotron2_tpu_torch.data.dataset import TextMelDataset, item_lengths
from tacotron2_tpu_torch.training.state import Batch


def process_index_and_count() -> Tuple[int, int]:
    """(rank, world size) of ``torch.distributed`` when it is initialised,
    else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DataPipeline:
    """Epoch iterator producing padded, bucketed ``Batch``es of CPU
    tensors, the items loaded in the thread that iterates it."""

    def __init__(self, dataset: TextMelDataset, config: Tacotron2Config,
                 batch_size: Optional[int] = None, drop_last: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        self.config = config
        pi, pc = process_index_and_count()
        pi = pi if process_index is None else process_index
        pc = pc if process_count is None else process_count
        # strided per-process shard of the (already seed-shuffled) dataset
        self.indices = list(range(pi, len(dataset), pc))
        # (text_len, mel_len) per item, from the text and the WAV header:
        # no audio is decoded for bucketing. Computed lazily, cached.
        self._lengths: Optional[List[Tuple[int, int]]] = None
        self.batch_size = batch_size or config.batch_size
        self.drop_last = drop_last

    @property
    def lengths(self) -> List[Tuple[int, int]]:
        if self._lengths is None:
            self._lengths = [item_lengths(self.dataset.entries[i],
                                          self.config)
                             for i in self.indices]
        return self._lengths

    def _sampler(self) -> BucketSampler:
        return BucketSampler(self.lengths, self.config, self.batch_size,
                             self.drop_last)

    def epoch(self, epoch_index: int, skip: int = 0) -> Iterator[Batch]:
        """Deterministically shuffled epoch of padded batches; the first
        ``skip`` batches are left out unassembled (a run resumed in the
        middle of an epoch)."""
        rng = np.random.RandomState(self.config.seed + epoch_index)
        for i, (shape, item_idxs) in enumerate(self._sampler().batches(rng)):
            if i >= skip:
                yield self._assemble(shape, item_idxs)

    def _assemble(self, shape: Tuple[int, int], item_idxs: List[int]
                  ) -> Batch:
        t_text, t_mel = shape
        n_real = len(item_idxs)
        if n_real < self.batch_size:
            # pad a partial (non-drop_last) batch to the full batch size by
            # cycling items: one shape per bucket. The cycled duplicates
            # are marked invalid in row_valid so that the validation loss
            # weights them out (training/loss.py).
            reps = -(-self.batch_size // n_real)
            item_idxs = (item_idxs * reps)[:self.batch_size]
        items = [self.dataset[self.indices[j]] for j in item_idxs]
        arrays = pad_batch(items, t_text, t_mel,
                           self.config.n_frames_per_step)
        row_valid = np.zeros((len(item_idxs),), np.float32)
        row_valid[:n_real] = 1.0
        return Batch(*(torch.from_numpy(a) for a in arrays),
                     row_valid=torch.from_numpy(row_valid))

    def steps_per_epoch(self) -> int:
        return sum(1 for _ in self._sampler().batches(
            np.random.RandomState(0)))


class _InFlight(NamedTuple):
    batch: Batch              # on the card, written by the copy stream
    done: torch.cuda.Event    # recorded on the copy stream after the copies
    pinned: Tuple[torch.Tensor, ...]  # the host sources, alive until received


class DeviceTransfer:
    """Copies batches to a CUDA device one ahead of their use.

    ``send`` runs in the prefetch thread: it copies each tensor of the batch
    into a fresh pinned host tensor (never reused while a copy from it may
    be pending: PyTorch's pinned allocator hands a freed block out again
    only after the copies recorded on it have finished) and starts an
    asynchronous copy to the card on a side stream. ``receive`` runs in the
    consumer: it makes the consumer's current stream wait for that copy and
    hands the tensors over to that stream (``record_stream``), so that
    their memory is not reused while the consumer may still read it.
    """

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceTransfer copies to a CUDA device, not "
                             f"{self.device}")
        self.stream = torch.cuda.Stream(self.device)

    def send(self, batch: Batch) -> _InFlight:
        pinned = tuple(None if t is None else t.pin_memory() for t in batch)
        with torch.cuda.stream(self.stream):
            moved = Batch(*(None if t is None
                            else t.to(self.device, non_blocking=True)
                            for t in pinned))
            done = torch.cuda.Event()
            done.record(self.stream)
        return _InFlight(moved, done, pinned)

    def receive(self, item: _InFlight) -> Batch:
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.done)
        for t in item.batch:
            if t is not None:
                t.record_stream(stream)
        return item.batch


def prefetch(iterator: Iterator, depth: int = 2,
             transfer=None) -> Iterator:
    """Run ``iterator`` in a background thread, keeping ``depth`` items
    ready: overlaps host batch assembly with device compute.

    ``transfer``: a ``DeviceTransfer`` (its ``send`` runs in the producer
    thread, its ``receive`` as each item is yielded), or any callable,
    applied to each item in the producer thread. A worker's exception is
    raised in the consumer."""
    send = getattr(transfer, "send", transfer)
    receive = getattr(transfer, "receive", None)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    error: List[BaseException] = []
    stop = threading.Event()

    def producer():
        try:
            for item in iterator:
                item = item if send is None else send(item)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # handed to the consumer, raised there
            error.append(e)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item if receive is None else receive(item)
    finally:
        # a consumer that stops early (break, an exception) releases the
        # producer, which then ends instead of blocking on a full queue
        stop.set()
        while thread.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                thread.join(0.01)
