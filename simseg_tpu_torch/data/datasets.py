"""The segmentation eval dataset and its loader (port of
``simseg_tpu/data/datasets.py``: ``SegDataset`` :146-199, ``_collate``
:233-253, ``DataLoader`` :256-386, ``build_seg_valid_loader`` :495-505).

Parity: reference ``simseg/datasets/seg/seg_dataset.py:13-81`` — the
pascal_voc / pascal_context / coco_stuff val splits, each sample the
transformed image and its label map at the raw size.

Images are decoded by ``data/image_io.py`` (the port's PNG reader; PIL
for a JPEG on the CPU, nvJPEG on the card) and transformed on the
loader's device, so a loader for the card yields ``image`` as a CUDA
uint8 tensor; labels are PNG palette indices read on the host, as numpy.
The CSV pair, parquet and ImageFolder datasets, the train mixing and the
train transforms are not ported (ROADMAP queue 1 items 9 and 10).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Any, Dict, Iterator, Sequence

import numpy as np
import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.data.image_io import decode_rgb, image_size, read_png_array
from simseg_tpu_torch.data.transforms import build_transforms


class SegDataset:
    """Val-only segmentation datasets on ``device`` (None: CUDA)."""

    LAYOUTS = {
        "pascal_voc": ("VOCdevkit/VOC2012", "JPEGImages", "SegmentationClass",
                       "ImageSets/Segmentation/val.txt"),
        "pascal_context": ("VOCdevkit/VOC2010", "JPEGImages",
                           "SegmentationClassContext",
                           "ImageSets/SegmentationContext/val.txt"),
        "coco_stuff": ("coco_stuff164k", "images/val2017", "annotations/val2017", None),
    }

    def __init__(self, cfg, name: str, transforms, device=None):
        if name not in self.LAYOUTS:
            raise NotImplementedError(f"dataset '{name}'")
        self.name = name
        self.transforms = transforms
        self.device = resolve_device(device)
        root, img_dir, label_dir, list_file = self.LAYOUTS[name]
        self.image_path = os.path.join(cfg.data.data_path, root, img_dir)
        self.label_path = os.path.join(cfg.data.data_path, root, label_dir)
        if list_file is not None:
            with open(os.path.join(cfg.data.data_path, root, list_file)) as f:
                self.names = [line.rstrip() for line in f]
        else:
            files = glob(os.path.join(self.image_path, "*.jpg"))
            self.names = [os.path.basename(p)[:-len(".jpg")] for p in files]

    def __len__(self) -> int:
        return len(self.names)

    def _label_file(self, item: str) -> str:
        label_name = item + ("_labelTrainIds" if self.name == "coco_stuff" else "")
        return os.path.join(self.label_path, label_name + ".png")

    def max_label_size(self) -> tuple:
        """(max_h, max_w) over all GT label maps, from the PNG headers only;
        cached, since the split does not change."""
        if not hasattr(self, "_max_label_size"):
            mh = mw = 0
            for item in self.names:
                w, h = image_size(self._label_file(item))
                mh, mw = max(mh, h), max(mw, w)
            self._max_label_size = (mh, mw)
        return self._max_label_size

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = self.names[index]
        with open(os.path.join(self.image_path, item + ".jpg"), "rb") as f:
            image = decode_rgb(f.read(), self.device)
        with open(self._label_file(item), "rb") as f:
            label = read_png_array(f.read())
        return {"image": self.transforms(image),
                "mask_label": label.astype(np.int32)}


def _collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a batch; ragged ``mask_label`` maps are padded to the batch's
    largest with 255 (the ignore index), their sizes in ``mask_h`` /
    ``mask_w``. Tensors stack as tensors on their device."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], torch.Tensor):
            out[k] = torch.stack(vals)
        elif k == "mask_label" and len({v.shape for v in vals}) > 1:
            max_h = max(v.shape[0] for v in vals)
            max_w = max(v.shape[1] for v in vals)
            padded = np.full((len(vals), max_h, max_w), 255, vals[0].dtype)
            for i, v in enumerate(vals):
                padded[i, :v.shape[0], :v.shape[1]] = v
            out[k] = padded
            out["mask_h"] = np.asarray([v.shape[0] for v in vals], np.int32)
            out["mask_w"] = np.asarray([v.shape[1] for v in vals], np.int32)
        else:
            out[k] = np.stack(vals)
    return out


class DataLoader:
    """Iterable over collated batches in the split's order, with threaded
    decode and background prefetch; ``shard_index`` of ``shard_count``
    takes every ``shard_count``-th sample. (The JAX loader's shuffle,
    drop_last and shard padding serve training, ROADMAP queue 1 item 10.)"""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 prefetch: int = 4, shard_index: int = 0, shard_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.shard_count = shard_count

    def __len__(self) -> int:
        n = max(0, (len(self.dataset) - self.shard_index + self.shard_count - 1)
                // self.shard_count)
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = list(range(len(self.dataset)))[self.shard_index::self.shard_count]
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # a plain put would block for ever once the consumer has left
            # the iterator with the queue full
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        batch = _collate(list(
                            pool.map(self.dataset.__getitem__, batch_idx)))
                        if not put_or_stop(batch):
                            return
                put_or_stop(None)
            except BaseException as exc:  # noqa: BLE001
                # handed to the consumer, which raises it
                put_or_stop(exc)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()


def process_shard():
    """(rank, world size) of an initialised ``torch.distributed`` group,
    else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def build_seg_valid_loader(cfg, name: str, device=None) -> DataLoader:
    """The loader of one seg val split (``cfg.data.batch_size_val`` images
    a batch, ``cfg.data.num_workers`` decode threads) on ``device``; in a
    ``torch.distributed`` group each rank loads a strided shard."""
    shard, nshards = process_shard()
    tf = build_transforms(cfg, "valid")
    return DataLoader(SegDataset(cfg, name, tf, device),
                      cfg.data.batch_size_val,
                      num_workers=cfg.data.num_workers,
                      shard_index=shard, shard_count=nshards)
