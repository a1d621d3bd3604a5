"""Training data pipeline over preprocessed (N, 4, 6) .npy shards (the
twin of scp_tpu/train/data.py: plain numpy, the same RNG streams, so its
batches are byte-equal to the JAX package's).

A host-side generator with a prefetch thread:

  * shards are memory-mapped; windows of `context_size` rows are drawn in
    a GLOBAL (cross-shard) random permutation re-drawn every epoch — the
    reference's DataLoader(shuffle=True) over all windows
    (oct_attn_dataloader.py:25), not just within-shard order;
  * occupancy is shifted 1..255 -> 0..254 at load; 255 = pad/unknown
    (reference oct_attn_dataset.py:35);
  * EHEM positions are the current node's, min-max normalized per window
    (reference ehem_dataset.py:46-48), and its channels are reordered to
    (level, octant, occupancy); OctAttention keeps (occupancy, level,
    octant) and divides all K ancestors' positions by 2^max_level, the
    file's deepest level (oct_attn_dataset.py:43);
  * variable-length robustness training (EHEM only) samples a bucket
    length from a fixed power-of-two set instead of a uniform random
    length, keeping the number of distinct shapes bounded (the
    reference's uniform draw, ehem.py:200-204).
"""

from __future__ import annotations

import glob
import queue
import threading

import numpy as np

from scp_tpu_torch.utils import profiling

EHEM_LEN_BUCKETS = (512, 1024, 2048, 4096, 8192)


class ShardDataset:
    """Iterates (data, pos, label) batches from .npy shards forever."""

    def __init__(
        self,
        root: str,
        context_size: int,
        batch_size: int,
        mode: str = "octattn",  # "octattn" | "ehem"
        vari_data_len: bool = False,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """batch_size is the PER-PROCESS (local) batch; under data-parallel
        training each rank draws a process-strided slice of every global
        batch, so the global batch content (and the epoch-keyed
        randomness) is independent of the process count
        (train/distributed.py)."""
        if mode not in ("octattn", "ehem"):
            raise ValueError(f"ShardDataset mode {mode!r}: 'octattn' or 'ehem'")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} of process_count {process_count}")
        self.files = sorted(glob.glob(root))
        if not self.files:
            raise FileNotFoundError(f"no shards match {root!r}")
        self.context_size = context_size
        self.batch_size = batch_size
        self.mode = mode
        self.vari_data_len = vari_data_len
        self.seed = int(seed)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.file_rows = []
        for f in self.files:
            try:
                self.file_rows.append(int(f.rsplit("_", 1)[-1].split(".")[0]))
            except ValueError:
                self.file_rows.append(np.load(f, mmap_mode="r").shape[0])
        self.total_nodes = sum(self.file_rows)

    def steps_per_epoch(self) -> int:
        """Derived from the WINDOW count (sum of floor(rows_i/csz)), not the
        raw row count: shard tails don't form windows, and an epoch must
        never wrap the permutation — each window is drawn at most once per
        epoch (the exactly-once property `batches` documents)."""
        global_bs = self.batch_size * self.process_count
        n_win = sum(r // self.context_size for r in self.file_rows)
        return max(n_win // global_bs, 1)

    def _window(self, shards, fi: int, w: int, max_levels: dict):
        """One (data(N,4,3) int32, pos float32, label int32) window;
        `max_levels` caches each file's deepest level."""
        csz = self.context_size
        shard = shards[fi]
        rows = np.array(shard[w * csz : (w + 1) * csz])
        rows[:, :, 0] -= 1  # occupancy 1..255 -> 0..254
        if self.mode == "ehem":
            pos = rows[:, -1, 3:6].astype(np.float32)
            lo, hi = pos.min(), pos.max()
            pos = (pos - lo) / (hi - lo + 1e-9)
            data = rows[:, :, :3]
            # (occ, level, octant) -> (level, octant, occ)
            data = np.concatenate((data[:, :, 1:], data[:, :, :1]), axis=2)
            label = data[:, -1, 2].copy()
        else:
            if fi not in max_levels:
                max_levels[fi] = int(shard[:, -1, 1].max())
            pos = (rows[:, :, 3:6] / float(2 ** max_levels[fi])).astype(np.float32)
            data = rows[:, :, :3]
            label = data[:, -1, 0].copy()
        return data.astype(np.int32), pos, label.astype(np.int32)

    def batches(self, start_step: int = 0):
        """Yield stacked batches; EHEM optionally truncates to a bucket.

        Batch `s` is a pure function of the global step `s` (and the seed):
        epoch e = s // steps_per_epoch draws its OWN cross-shard window
        permutation and bucket-truncation randomness from
        default_rng(seed, e) — the reference DataLoader's shuffle=True,
        oct_attn_dataloader.py:25, re-drawn per epoch.  A resumed run
        passes start_step and sees exactly the batches an uninterrupted
        run would have seen from that step on (round-3 resume replayed
        epoch-0 order and dropped the first prefetched batch)."""
        csz = self.context_size
        shards = [np.load(f, mmap_mode="r") for f in self.files]
        index = [
            (fi, w) for fi, s in enumerate(shards) for w in range(s.shape[0] // csz)
        ]
        if not index:
            raise ValueError(
                f"every shard is shorter than context_size={csz}; "
                "no training windows can be drawn"
            )
        n_win = len(index)
        spe = self.steps_per_epoch()
        max_levels: dict[int, int] = {}
        step = start_step
        while True:
            epoch = step // spe
            erng = np.random.default_rng([self.seed, epoch])
            perm = erng.permutation(n_win)
            # per-step randomness pre-drawn for the WHOLE epoch so a
            # mid-epoch entry replays the identical truncation choices
            draws = erng.random(spe)
            sizes = erng.choice(EHEM_LEN_BUCKETS, size=spe)
            while step // spe == epoch:
                i = step % spe
                # this process's contiguous slice of global batch i: the
                # global batch is [p0 rows | p1 rows | ...] in process order
                base = (i * self.process_count + self.process_index) * self.batch_size
                items = [
                    self._window(shards, *index[perm[(base + j) % n_win]], max_levels)
                    for j in range(self.batch_size)
                ]
                data = np.stack([x[0] for x in items])
                pos = np.stack([x[1] for x in items])
                label = np.stack([x[2] for x in items])
                if self.mode == "ehem" and self.vari_data_len and draws[i] < 0.3:
                    sz = int(sizes[i])
                    if sz < data.shape[1]:
                        data, pos, label = data[:, :sz], pos[:, :sz], label[:, :sz]
                yield {"data": data, "pos": pos, "label": label}
                step += 1


def prefetch(generator, depth: int = 2):
    """Host-side prefetch thread (the reference's worker pool equivalent).
    Worker exceptions are re-raised in the consumer — a dead worker must
    not masquerade as normal end-of-data (StopIteration)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    class _Raise:
        """Unique wrapper so error hand-over can never collide with a
        legitimately yielded value (e.g. a ('tag', payload) tuple)."""

        def __init__(self, exc):
            self.exc = exc

    def worker():
        try:
            for item in generator:
                q.put(item)
            q.put(stop)
        except BaseException as e:  # noqa: BLE001 — hand ANY failure over
            q.put(_Raise(e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        with profiling.span("train.load_wait"):
            item = q.get()
        if item is stop:
            return
        if isinstance(item, _Raise):
            raise item.exc
        yield item


def build_dataset(cfg) -> ShardDataset:
    """The training dataset of a config.  cfg.data.batch_size is the
    GLOBAL batch; each rank of the process group yields its 1/world slice,
    and a batch that does not divide raises."""
    from scp_tpu_torch.train import distributed

    mode = "ehem" if str(cfg.data.dataset_name).upper().startswith("EHEM") else "octattn"
    pcount, pid = distributed.world_size(), distributed.rank()
    global_bs = int(cfg.data.batch_size)
    if global_bs % pcount:
        raise ValueError(f"global batch {global_bs} not divisible by {pcount} processes")
    return ShardDataset(
        root=cfg.data.root,
        context_size=cfg.data.context_size,
        batch_size=global_bs // pcount,
        mode=mode,
        vari_data_len=bool(cfg.data.get("vari_data_len", False)),
        seed=int(cfg.get("seed", 42)),
        process_index=pid,
        process_count=pcount,
    )
