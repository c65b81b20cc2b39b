"""Host-side datasets and the feed to the card, counterparts of
`uformer_tpu/data/datasets.py` (reference `dataset/dataset_denoise.py`,
`dataset_motiondeblur.py`).

Paired loaders with the reference's directory contract (`<dir>/groundtruth`
and `<dir>/input` image pairs), random aligned crops and the 8 dihedral
ops drawn on the host in index order, on the native (C++) plane or in
numpy; `batch_iterator` yields numpy batches in a seeded order per epoch
(with `local_range`, a data rank's rows of each global batch), and
`prefetch_to_device` moves them to the card on a side stream while the
current step computes.

Two divergences from the JAX package: an exception in the prefetch's
producer is raised again in the consumer, where the JAX prefetch ends the
epoch early without a word; and with `local_range` a rank's crops and
dihedral ops are the global batch's draws for its rows (JAX draws them
for the local rows only), so a data-parallel epoch sees the batches of
the one-process epoch.
"""

from __future__ import annotations

import glob
import os
import queue as queue_mod
import struct
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from uformer_tpu_torch.data import native as native_plane
from uformer_tpu_torch.eval.image_io import load_img

_IMG_EXTS = ("*.png", "*.PNG", "*.jpg", "*.JPG", "*.jpeg", "*.bmp")


def _list_images(d: str) -> list:
    out = []
    for e in _IMG_EXTS:
        out.extend(glob.glob(os.path.join(d, e)))
    return sorted(out)


def _paired_files(data_dir: str) -> Tuple[list, list]:
    gt = _list_images(os.path.join(data_dir, "groundtruth"))
    inp = _list_images(os.path.join(data_dir, "input"))
    if len(gt) != len(inp) or not gt:
        raise ValueError(f"no paired data under {data_dir}: {len(gt)} "
                         f"groundtruth and {len(inp)} input images")
    return gt, inp


def _apply_dihedral(img: np.ndarray, k: int) -> np.ndarray:
    """The 8 ops of reference Augment_RGB_torch (utils/dataset_utils.py:5-30),
    HWC numpy."""
    if k == 0:
        return img
    if k <= 3:
        return np.rot90(img, k, (0, 1))
    if k == 4:
        return img[::-1]
    return np.rot90(img, k - 4, (0, 1))[::-1]


def _image_hw(path: str) -> Tuple[int, int]:
    """(H, W) of an image file: a PNG's from its header, any other
    decoded."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
        W, H = struct.unpack(">II", head[16:24])
        return H, W
    return load_img(path).shape[:2]


def _pad_to_patch(img: np.ndarray, ps: int) -> np.ndarray:
    """Reflect-pad an image smaller than ps x ps at its bottom and right
    (the reference assumes images of at least ps)."""
    H, W = img.shape[:2]
    if H >= ps and W >= ps:
        return img
    return np.pad(img, ((0, max(0, ps - H)), (0, max(0, ps - W)), (0, 0)),
                  mode="reflect")


class PairedTrainDataset:
    """Paired groundtruth/input patches with random crop + dihedral aug
    (reference DataLoaderTrain, dataset_denoise.py:20-73).

    `native="auto"` takes the C++ plane (`data.native`: fused crop +
    dihedral + normalise, threaded) where its library builds, numpy
    otherwise; True requires it. Decoded images stay in an LRU of
    `cache_mb` MiB (default UFORMER_TPU_DECODE_CACHE_MB, else 1024; 0
    turns it off), so that from the second epoch a batch reads RAM
    instead of inflating PNGs."""

    def __init__(self, data_dir: str, patch_size: int = 128, seed: int = 1234,
                 native: object = "auto", decode_threads: int = 8,
                 cache_mb: Optional[int] = None):
        self.gt_files, self.in_files = _paired_files(data_dir)
        self.ps = patch_size
        if cache_mb is None:
            cache_mb = int(os.environ.get("UFORMER_TPU_DECODE_CACHE_MB",
                                          "1024"))
        self._cache_budget = int(cache_mb) * 2**20
        self._cache = OrderedDict() if self._cache_budget > 0 else None
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()
        self.rng = np.random.default_rng(seed)
        self.decode_threads = decode_threads
        self._decode_pool = None
        if native == "auto":
            self.use_native = native_plane.native_available()
        else:
            self.use_native = bool(native)

    def _load_u8(self, path: str) -> np.ndarray:
        import cv2

        return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)

    def _load_cached(self, path: str) -> np.ndarray:
        """Decode `path` through the LRU (uint8 for the native plane,
        float32 in [0, 1] for numpy); cached arrays are never mutated
        downstream (crop and aug always make new buffers)."""
        c = self._cache
        if c is not None:
            with self._cache_lock:
                hit = c.get(path)
                if hit is not None:
                    c.move_to_end(path)
                    return hit
        img = (self._load_u8 if self.use_native else load_img)(path)
        if c is not None and img.nbytes <= self._cache_budget:
            with self._cache_lock:
                if path not in c:
                    c[path] = img
                    self._cache_bytes += img.nbytes
                    while self._cache_bytes > self._cache_budget:
                        _, old = c.popitem(last=False)
                        self._cache_bytes -= old.nbytes
        return img

    def _pool(self) -> ThreadPoolExecutor:
        # cv2.imread releases the GIL while it inflates a PNG, so threads
        # decode in parallel (reference: 4 torch workers,
        # train_denoise.py:128)
        if self._decode_pool is None:
            self._decode_pool = ThreadPoolExecutor(
                max_workers=self.decode_threads)
        return self._decode_pool

    def close(self) -> None:
        """Shut down the decode pool (idempotent)."""
        pool = getattr(self, "_decode_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
            self._decode_pool = None

    def __del__(self):
        self.close()

    def draws(self, shapes) -> Tuple[list, list, list]:
        """Crop origins and dihedral ops for images of these (H, W),
        drawn serially in index order: rows, cols, ks."""
        ps = self.ps
        rows, cols, ks = [], [], []
        for H, W in shapes:
            rows.append(int(self.rng.integers(0, H - ps + 1)))
            cols.append(int(self.rng.integers(0, W - ps + 1)))
            ks.append(int(self.rng.integers(0, 8)))
        return rows, cols, ks

    def get_batch(self, indices, rows: Optional[slice] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Threaded decode, then crop/aug/normalise on the C++ plane or in
        numpy: float32 (B, ps, ps, 3) ground truth and input.

        The crop and aug draws happen serially in index order after the
        decode, on both planes: drawn inside the pool's workers they would
        depend on thread interleaving (and race on the Generator). With
        `rows`, the draws are made for all of `indices` (from the images'
        sizes: a PNG's header, any other decoded) and only indices[rows]
        are loaded: a data rank's share of a global batch."""
        ps = self.ps
        keep = list(indices) if rows is None else list(indices)[rows]
        paths = [self.gt_files[i] for i in keep] + \
            [self.in_files[i] for i in keep]
        imgs = [_pad_to_patch(im, ps)
                for im in self._pool().map(self._load_cached, paths)]
        gts, nys = imgs[:len(keep)], imgs[len(keep):]
        if rows is None:
            rows, cols, ks = self.draws([g.shape[:2] for g in gts])
        else:
            share = rows
            rows, cols, ks = (d[share] for d in self.draws(
                [self._patch_hw(i) for i in indices]))
        if self.use_native:
            return native_plane.augment_pair_batch(
                gts, nys, ps, np.asarray(rows), np.asarray(cols),
                np.asarray(ks))
        gt_out = np.stack([
            np.ascontiguousarray(_apply_dihedral(g[r:r + ps, c:c + ps], k))
            for g, r, c, k in zip(gts, rows, cols, ks)])
        ny_out = np.stack([
            np.ascontiguousarray(_apply_dihedral(n[r:r + ps, c:c + ps], k))
            for n, r, c, k in zip(nys, rows, cols, ks)])
        return gt_out, ny_out

    def _patch_hw(self, idx: int) -> Tuple[int, int]:
        """(H, W) of ground truth idx after `_pad_to_patch`."""
        H, W = _image_hw(self.gt_files[idx])
        return max(H, self.ps), max(W, self.ps)

    def __len__(self):
        return len(self.gt_files)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        ps = self.ps
        gt = _pad_to_patch(load_img(self.gt_files[idx]), ps)
        noisy = _pad_to_patch(load_img(self.in_files[idx]), ps)
        (r,), (c,), (k,) = self.draws([gt.shape[:2]])
        gt = _apply_dihedral(gt[r:r + ps, c:c + ps], k)
        noisy = _apply_dihedral(noisy[r:r + ps, c:c + ps], k)
        return np.ascontiguousarray(gt), np.ascontiguousarray(noisy)


class PairedValDataset:
    """Full-image paired val loader (reference DataLoaderVal); optional
    center crop to val_ps (the deblur variant,
    dataset_motiondeblur.py:143-145)."""

    def __init__(self, data_dir: str, center_crop: Optional[int] = None):
        self.gt_files, self.in_files = _paired_files(data_dir)
        self.center_crop = center_crop

    def __len__(self):
        return len(self.gt_files)

    def __getitem__(self, idx: int):
        gt = load_img(self.gt_files[idx])
        noisy = load_img(self.in_files[idx])
        if self.center_crop:
            ps = self.center_crop
            H, W = gt.shape[:2]
            r, c = (H - ps) // 2, (W - ps) // 2
            gt = gt[r:r + ps, c:c + ps]
            noisy = noisy[r:r + ps, c:c + ps]
        name = os.path.splitext(os.path.basename(self.in_files[idx]))[0]
        return gt, noisy, name


class InputOnlyDataset:
    """Input-only loader for benchmark submissions (reference
    DataLoaderTest, dataset_denoise.py:116-136)."""

    def __init__(self, data_dir: str):
        self.files = _list_images(data_dir)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        name = os.path.splitext(os.path.basename(self.files[idx]))[0]
        return load_img(self.files[idx]), name


# Factory functions mirroring the reference API
# (dataset_denoise.py:139-150, dataset_motiondeblur.py:179-190)

def get_training_data(data_dir: str, img_options: dict):
    return PairedTrainDataset(data_dir, img_options.get("patch_size", 128))


def get_validation_data(data_dir: str):
    return PairedValDataset(data_dir)


def get_validation_deblur_data(data_dir: str,
                               img_options: Optional[dict] = None):
    cc = (img_options or {}).get("patch_size")
    return PairedValDataset(data_dir, center_crop=cc)


def get_test_data(data_dir: str):
    return InputOnlyDataset(data_dir)


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   drop_last: bool = True, seed: int = 0,
                   num_threads: int = 4,
                   local_range: Optional[Tuple[int, int]] = None
                   ) -> Iterator[dict]:
    """Yield {'target', 'input'} NHWC float32 numpy batches in an order
    shuffled by `seed`. A dataset with `get_batch` decodes in its own
    threads and draws its crops serially; any other is loaded sample by
    sample on a pool of num_threads (reference: 4 torch workers,
    train_denoise.py:128).

    local_range=(start, size): a data rank's share. Every rank walks the
    same seeded order, and loads only rows [start, start + size) of each
    global batch of `batch_size` (`parallel.multihost.local_batch_range`);
    drop_last must hold. A `get_batch` dataset draws the global batch's
    crops and keeps this rank's (`rows`)."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if local_range is not None and not drop_last:
        raise ValueError("local_range needs drop_last: a short last batch "
                         "does not split into the ranks' rows")
    r0, rsz = local_range if local_range is not None else (0, batch_size)
    if hasattr(dataset, "get_batch"):
        for i0 in range(0, n, batch_size):
            idx = order[i0:i0 + batch_size]
            if len(idx) < batch_size and drop_last:
                return
            gt, noisy = (dataset.get_batch(idx) if local_range is None else
                         dataset.get_batch(idx, rows=slice(r0, r0 + rsz)))
            yield {"target": gt, "input": noisy}
        return
    with ThreadPoolExecutor(max_workers=max(num_threads, 1)) as pool:
        for i0 in range(0, n, batch_size):
            idx = order[i0:i0 + batch_size]
            if len(idx) < batch_size and drop_last:
                return
            samples = list(pool.map(dataset.__getitem__, idx[r0:r0 + rsz]))
            gt = np.stack([s[0] for s in samples])
            noisy = np.stack([s[1] for s in samples])
            yield {"target": gt, "input": noisy}


class _Failed:
    """A producer's exception, carried to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_to_device(it: Iterator[dict], device="cuda",
                       size: int = 2) -> Iterator[dict]:
    """Iterate `it`'s batches (dicts of numpy arrays or tensors) as dicts
    of tensors on `device`, up to `size` batches ahead.

    On the card a producer thread pins each batch and copies it with
    non_blocking=True on a side stream, recording an event after the copy;
    the consumer makes the current stream wait on that event and marks
    each tensor as used by the current stream (`record_stream`), so the
    caching allocator cannot hand its memory out again while a step still
    reads it. On the CPU it is a plain threaded prefetch. An exception in
    the producer is raised again here, after the batches before it."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_card else None
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    stop = object()
    closed = threading.Event()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def move(batch: dict):
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        if not on_card:
            return host, None
        with torch.cuda.stream(side):
            out = {k: v.pin_memory().to(device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def producer():
        try:
            for batch in it:
                if not put(move(batch)):
                    return
        except Exception as exc:  # handed to the consumer, raised there
            put(_Failed(exc))
        finally:
            put(stop)

    t = threading.Thread(target=producer, daemon=True,
                         name="prefetch_to_device")
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, _Failed):
                raise item.exc
            batch, done = item
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                for v in batch.values():
                    v.record_stream(current)
            yield batch
    finally:
        closed.set()
        t.join(timeout=60)
