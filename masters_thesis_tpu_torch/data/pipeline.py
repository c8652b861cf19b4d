"""Host-side input pipeline producing device-ready batches.

Replaces the reference's ``keras.utils.Sequence`` generators
(AttemptFour/DataLoaders/data_generator_guse.py) with a prefetching,
seed-deterministic batcher:

- epoch-end shuffling with a dedicated ``np.random.Generator`` (reference
  shuffles with the global RNG, data_generator_guse.py:67-71);
- drops the ragged tail batch (``len(pairs) // batch_size`` batches per epoch,
  reference __len__ :63-65);
- captions are already tokenised (see data/pairs.py), so a batch is just an
  index/token slice — betas either gathered on host or left as indices for
  on-device gather from an HBM-resident store;
- background-thread prefetch with a bounded queue so host work overlaps the
  TPU step.

Batches are dicts of numpy arrays:
  ``idx``     (B,)   int32 — row indices into the beta/feature store
  ``tokens``  (B,T)  int32 — input caption ids
  ``target``  (B,T)  int32 — left-shifted ids (loss does one-hot on device)
  ``subject`` (B,)   int32 — subject index (multi-subject models)
  optional ``betas`` (B,D) float — only when the store is host-resident

The port's own copy of ``masters_thesis_tpu/data/pipeline.py``
(``BatchPipeline`` and ``EvalPipeline``, with the same names and meaning;
``tests/test_torch_copies.py`` holds the batch orders together). The JAX
package's ``device_prefetch`` is not copied: the port's store lives on the
card, and a batch crosses to it as row ids.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from masters_thesis_tpu_torch.data.pairs import EncodedPairs, shift_target
from masters_thesis_tpu_torch.data.store import ArrayStore


class BatchPipeline:
    def __init__(
        self,
        pairs: EncodedPairs,
        store: ArrayStore | None,
        batch_size: int,
        seed: int = 42,
        shuffle: bool = True,
        prefetch: int = 2,
        drop_remainder: bool = True,
        subject_split: bool = False,
        self_target: bool = False,
    ):
        self.pairs = pairs
        self.store = store
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.seed = seed
        self.rng = np.random.Generator(np.random.PCG64(seed))
        n = len(pairs)
        self.steps_per_epoch = n // batch_size if drop_remainder else -(-n // batch_size)
        self.subject_split = subject_split
        if subject_split:
            # ms2_NIC batch contract: rows [0, bs/2) are subject A, rows
            # [bs/2, bs) subject B (the reference generator builds every
            # batch this way, data_generator_multisub.py:90-102;
            # DualSubjectEncoder routes the halves to encoder_a/encoder_b).
            # A uniformly shuffled batch would silently train each encoder
            # on mixed-subject rows.
            subs = np.unique(pairs.subjects)
            if len(subs) != 2:
                raise ValueError(
                    f"subject_split needs exactly 2 subject ids, got "
                    f"{subs.tolist()} — assign pairs.subjects per subject")
            if batch_size % 2:
                raise ValueError("subject_split needs an even batch size")
            self._sub_idx = [np.nonzero(pairs.subjects == s)[0] for s in subs]
            half = batch_size // 2
            self.steps_per_epoch = min(len(i) for i in self._sub_idx) // half
        # self_target: UNSHIFTED targets for the ThinkAndTell loss window
        # (model.py:271 supervises target[:, i] = tokens[:, i] against the
        # output that consumed [feat, w_0..w_{i-1}] — ShowTell align="self")
        self.targets = (pairs.tokens.copy() if self_target
                        else shift_target(pairs.tokens))
        if store is not None:
            self.store_idx = store.indices_for(pairs.keys)
        else:
            self.store_idx = np.zeros(n, dtype=np.int32)

    def _order(self, epoch: int | None = None) -> np.ndarray:
        # epoch-INDEXED shuffling (round 5): with an epoch number the
        # permutation is a pure function of (seed, epoch), so a resumed run
        # replays exactly the batch orders the uninterrupted run would have
        # seen — resume is then trajectory-exact, not just state-exact.
        # (The stateful self.rng path remains for epoch()-without-index
        # callers; the reference reshuffles with the global RNG and has no
        # resume-order story at all, data_generator_guse.py:67-71.)
        rng = (np.random.Generator(
            np.random.PCG64((self.seed, 1 + epoch)))
            if epoch is not None else self.rng)
        if self.subject_split:
            half = self.batch_size // 2
            idx_a, idx_b = (i.copy() for i in self._sub_idx)
            if self.shuffle:
                rng.shuffle(idx_a)
                rng.shuffle(idx_b)
            parts = []
            for step in range(self.steps_per_epoch):
                parts.append(idx_a[step * half:(step + 1) * half])
                parts.append(idx_b[step * half:(step + 1) * half])
            return (np.concatenate(parts) if parts
                    else np.zeros(0, np.int64))
        order = np.arange(len(self.pairs))
        if self.shuffle:
            rng.shuffle(order)
        return order

    def _make_batch(self, sel: np.ndarray) -> dict:
        batch = {
            # pair indices into this pipeline's pair tables — the
            # table-resident scanned trainer ships ONLY these per epoch
            "sel": sel.astype(np.int32),
            "idx": self.store_idx[sel],
            "tokens": self.pairs.tokens[sel],
            "target": self.targets[sel],
            "subject": self.pairs.subjects[sel],
            # NSD keys ride along host-side (never device_put — see
            # device_batches); previews use them to find stimulus images
            "keys": self.pairs.keys[sel],
        }
        if self.store is not None and not self.store.device_resident:
            batch["betas"] = self.store.gather_host(batch["idx"])
        return batch

    def epoch(self, epoch: int | None = None):
        """Iterate one epoch of batches, prefetched on a background thread.
        ``epoch``: index for resume-exact deterministic shuffling (see
        ``_order``); None keeps the legacy stateful stream."""
        order = self._order(epoch)
        bs = self.batch_size
        n_steps = self.steps_per_epoch

        if self.prefetch <= 0:
            for step in range(n_steps):
                yield self._make_batch(order[step * bs : (step + 1) * bs])
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def producer():
            # a failed batch must FAIL the epoch, not silently truncate it:
            # the error is shipped through the queue and re-raised in the
            # consumer (a bare-thread exception would only hit stderr)
            try:
                for step in range(n_steps):
                    batch = self._make_batch(order[step * bs : (step + 1) * bs])
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as exc:  # noqa: BLE001 — relayed, not dropped
                while not stop.is_set():
                    try:
                        q.put(exc, timeout=0.2)
                        return
                    except queue.Full:
                        continue
            else:
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.2)
                        return
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # abandoned mid-epoch (early break / preemption interrupt):
            # release the producer from its bounded-queue put and reap it
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)

    def __len__(self) -> int:
        return self.steps_per_epoch


class EvalPipeline(BatchPipeline):
    """Deterministic, unshuffled iteration (keeps the tail batch padded).

    Pads the final ragged batch by repeating its last row so every batch has a
    static shape for jit; ``valid`` marks real rows.
    """

    def __init__(self, pairs, store, batch_size, **kw):
        kw.setdefault("shuffle", False)
        kw.setdefault("drop_remainder", False)
        super().__init__(pairs, store, batch_size, **kw)

    def _make_batch(self, sel: np.ndarray) -> dict:
        bs = self.batch_size
        valid = np.ones(bs, dtype=bool)
        if len(sel) < bs:
            valid[len(sel):] = False
            sel = np.concatenate([sel, np.full(bs - len(sel), sel[-1], dtype=sel.dtype)])
        batch = super()._make_batch(sel)
        batch["valid"] = valid
        batch["keys"] = self.pairs.keys[sel]
        return batch
