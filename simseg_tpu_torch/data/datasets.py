"""Datasets and the host-side prefetching loader (port of
``simseg_tpu/data/datasets.py``: ``CsvPairDataset`` :48-108,
``ParquetRetrievalDataset`` :111-143, ``SegDataset`` :146-199,
``ImageFolderDataset`` :202-230, ``_collate`` :233-253, ``DataLoader``
:256-378, ``ConcatDataset``, the train mixing :380-420,
``build_clip_dataloaders`` :432-492, ``build_seg_valid_loader`` :495-505
and ``build_imagenet_dataloaders`` :517-538).

Parity: reference ``simseg/datasets/clip/clip_dataset.py`` (CSV
image-caption pairs with train-time caption corruption; f30k / coco
``valid.parquet``; the shuffle / sequential / debias train modes) and
``simseg/datasets/seg/seg_dataset.py:13-81`` (the pascal_voc /
pascal_context / coco_stuff val splits, each sample the transformed image
and its label map at the raw size) and ``linear_prob/linear_dataset.py``
(ImageNet's class-per-directory folders).

Images are decoded by ``data/image_io.py`` (the port's PNG reader; PIL
for a JPEG on the CPU, nvJPEG on the card). The seg loader transforms on
its device, so a loader for the card yields ``image`` as a CUDA uint8
tensor. The pair datasets decode and augment on the host (the train ops
are PIL's, ``data/train_transforms.py``), as the JAX loader does, and
yield CPU uint8 tensors; the runner normalises them on the device. Labels
and token ids are numpy. In train mode ``CsvPairDataset`` and
``ImageFolderDataset`` read through the train pipeline's ``load`` (the
native decode library under ``data.native_decode``, ``data/native.py``),
as JAX's do (``simseg_tpu/data/datasets.py:93,223``); ``SegDataset`` and
every valid split keep the port's reader, as JAX's keep PIL.
"""

from __future__ import annotations

import csv
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np
import torch

from simseg_tpu_torch import resolve_device
from simseg_tpu_torch.data.corruption import process_caption
from simseg_tpu_torch.data.image_io import decode_rgb, image_size, read_png_array
from simseg_tpu_torch.data.transforms import build_transforms


def read_csv_columns(path: str) -> Dict[str, List[str]]:
    """A CSV file with a header row as {column: [field, ...]}, read as
    ``pandas.read_csv`` reads it: RFC 4180 quoting (quoted commas, doubled
    quotes, line breaks inside quotes), UTF-8 with or without a BOM, blank
    lines skipped."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    for i, row in enumerate(body):
        if len(row) != len(header):
            raise ValueError(f"{path}: row {i + 2} has {len(row)} fields, "
                             f"the header {len(header)}")
    return {name: [r[j] for r in body] for j, name in enumerate(header)}


def _tokenize_one(tokenizer, caption: str, max_length: int):
    """(input_ids, attention_mask) int32 of one caption, through the
    batch-of-one call the JAX datasets make."""
    enc = tokenizer([caption], padding="max_length", truncation=True,
                    max_length=max_length)
    return (np.asarray(enc["input_ids"][0], np.int32),
            np.asarray(enc["attention_mask"][0], np.int32))


def _load_image(transforms, path: str, mode: str):
    """A file through ``transforms``: its ``load`` in train mode (the native
    head), else the port's reader and the ops."""
    if mode == "train" and hasattr(transforms, "load"):
        return transforms.load(path)
    with open(path, "rb") as f:
        return transforms(decode_rgb(f.read(), "cpu"))


class CsvPairDataset:
    """``<data_path>/<name>/{train,valid}_anno.csv`` rows (image, caption[,
    image_id, caption_id]), images under ``<name>/{train,valid}/``.

    In train mode each caption is corrupted with its own rng, seeded by
    (``cfg.seed``, epoch, index), so that a resumed or threaded run replays
    the same captions; in valid mode the sample carries ``image_id`` and
    ``caption_id`` (the row index where the column is absent)."""

    def __init__(self, cfg, name: str, tokenizer, transforms, mode: str = "train"):
        self.name = name
        self.mode = mode
        self.tokenizer = tokenizer
        self.transforms = transforms
        self.max_length = cfg.model.max_length
        self.seed = int(cfg.get("seed", 0) or 0)
        self.epoch = 0
        split = "train" if mode == "train" else "valid"
        self.image_base = os.path.join(cfg.data.data_path, name, split)
        cols = read_csv_columns(os.path.join(cfg.data.data_path, name,
                                             f"{split}_anno.csv"))
        self.images = cols["image"]
        self.captions = cols["caption"]
        self.image_ids = ([int(v) for v in cols["image_id"]]
                          if "image_id" in cols else None)
        self.caption_ids = ([int(v) for v in cols["caption_id"]]
                            if "caption_id" in cols else None)

    def __len__(self) -> int:
        return len(self.captions)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __getitem__(self, index: int) -> Dict[str, Any]:
        caption = self.captions[index]
        if self.mode == "train":
            rng = random.Random(
                (self.seed * 1_000_003 + self.epoch) * 1_000_003 + index)
            caption = process_caption(self.tokenizer, caption, rng=rng)
        ids, mask = _tokenize_one(self.tokenizer, caption, self.max_length)
        path = os.path.join(self.image_base, self.images[index])
        sample = {"image": _load_image(self.transforms, path, self.mode),
                  "input_ids": ids, "attention_mask": mask}
        if self.mode != "train" and self.image_ids is not None:
            sample["image_id"] = np.int64(self.image_ids[index])
            sample["caption_id"] = np.int64(
                self.caption_ids[index] if self.caption_ids is not None
                else index)
        return sample


class ParquetRetrievalDataset:
    """f30k / coco ``<data_path>/<name>/valid.parquet`` (columns imbytes,
    caption, image_id, id), read through pyarrow."""

    def __init__(self, cfg, name: str, tokenizer, transforms):
        try:
            import pyarrow.parquet as pq
        except ImportError as err:
            raise ImportError(f"{name}/valid.parquet: reading parquet needs "
                              "pyarrow, which is not installed") from err
        self.tokenizer = tokenizer
        self.transforms = transforms
        self.max_length = cfg.model.max_length
        table = pq.read_table(os.path.join(cfg.data.data_path, name,
                                           "valid.parquet"))
        self.images = table.column("imbytes").to_pylist()
        self.captions = table.column("caption").to_pylist()
        self.image_ids = table.column("image_id").to_pylist()
        self.caption_ids = table.column("id").to_pylist()

    def __len__(self) -> int:
        return len(self.captions)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        ids, mask = _tokenize_one(self.tokenizer, self.captions[index],
                                  self.max_length)
        return {
            "image": self.transforms(decode_rgb(self.images[index], "cpu")),
            "input_ids": ids,
            "attention_mask": mask,
            "image_id": np.int64(self.image_ids[index]),
            "caption_id": np.int64(self.caption_ids[index]),
        }


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


class ImageFolderDataset:
    """``root/<class>/<image>``: classes in sorted order numbered from 0,
    each class's files sorted; a sample is the transformed image and its
    int64 ``label``."""

    def __init__(self, root: str, transforms):
        self.transforms = transforms
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List = []
        for c in classes:
            for path in sorted(glob(os.path.join(root, c, "*"))):
                self.samples.append((path, self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        path, label = self.samples[index]
        return {"image": _load_image(self.transforms, path,
                                     getattr(self.transforms, "mode", "")),
                "label": np.int64(label)}


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
    """Iterable over collated batches with threaded decode and background
    prefetch, deterministic per (seed, epoch). ``shuffle`` permutes the
    indices with ``random.Random(seed + epoch)``; ``shard_index`` of
    ``shard_count`` takes every ``shard_count``-th index, after wrap-padding
    the list to a multiple of ``shard_count`` when ``pad_shards`` (every
    shard the same length, as torch's DistributedSampler); ``drop_last``
    drops a short final batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8,
                 prefetch: int = 4, seed: int = 0, shard_index: int = 0,
                 shard_count: int = 1, pad_shards: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.pad_shards = pad_shards

    def set_epoch(self, epoch: int) -> None:
        """The epoch of the shuffle, forwarded to the dataset (its caption
        corruption keys on it)."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> List[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        if self.shard_count > 1 and self.pad_shards and idx:
            total = -(-len(idx) // self.shard_count) * self.shard_count
            idx = (idx * self.shard_count)[:total]
        return idx[self.shard_index::self.shard_count]

    def __len__(self) -> int:
        # arithmetic: no index list is built
        n = len(self.dataset)
        if self.shard_count > 1:
            if self.pad_shards and n:
                n = -(-n // self.shard_count)
            else:
                n = max(0, (n - self.shard_index + self.shard_count - 1)
                        // self.shard_count)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = self._indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

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


class ConcatDataset:
    """Datasets end to end, indexed as one."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def set_epoch(self, epoch: int) -> None:
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, index: int):
        ds = int(np.searchsorted(self.offsets, index, side="right")) - 1
        return self.datasets[ds][index - int(self.offsets[ds])]


def sequential_batches(loaders: Sequence[DataLoader]) -> Iterator:
    """One loader after another (parity: clip_runner.py:109-138)."""
    for loader in loaders:
        yield from loader


def debias_batches(loaders: Sequence[DataLoader], seed: int = 0) -> Iterator:
    """Per step a loader drawn with weights proportional to its remaining
    batches (parity: clip_runner.py:140-183). Every loader's producer
    starts at once, so with random train ops their draws from the shared
    ``random`` interleave by thread timing, as in the JAX package."""
    rng = random.Random(seed)
    iters = [iter(l) for l in loaders]
    remaining = [len(l) for l in loaders]
    while any(r > 0 for r in remaining):
        choice = rng.choices(range(len(iters)), weights=remaining)[0]
        try:
            yield next(iters[choice])
            remaining[choice] -= 1
        except StopIteration:
            remaining[choice] = 0


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


def build_clip_dataloaders(cfg, tokenizer=None) -> Dict[str, Any]:
    """The CLIP task's loaders (parity: clip_dataset.py:237-253):
    {"train": [loader, ...], "train_dataset": [dataset, ...] or None,
    "val": [loader, ...]}. ``data.train_type`` 'shuffle' concatenates the
    train sets into one shuffled loader, 'sequential' and 'debias' keep one
    loader per set. A valid set is ``valid.parquet`` where that file
    exists, else its CSV. The batch is ``data.batch_size`` over the data
    ranks of the ``torch.distributed`` world (one process unless a group is
    initialised; ``dist.tp_size`` ranks to a model group, which loads one
    shard, and the ``dist.pp_size`` stages' ranks of one data index load
    one shard); ``data.single_eval`` gives every process the whole valid set. ``tokenizer``: where None, JAX's ``build_tokenizer`` over the tag
    and ``data.vocab_file``."""
    if tokenizer is None:
        from simseg_tpu_torch.data.tokenizer import build_tokenizer

        tokenizer = build_tokenizer(cfg.model.text_encoder.tag,
                                    vocab_file=cfg.data.get("vocab_file"))
    shard, nshards = process_shard()
    # the stages' ranks of one data index (dist.pp_size, the outermost) and
    # a model group's ranks (dist.tp_size) load one data rank's shard
    pp = max(int(cfg.dist.get("pp_size", 1) or 1), 1)
    if pp > 1 and nshards % pp == 0:
        shard, nshards = shard % (nshards // pp), nshards // pp
    tp = max(int(cfg.dist.get("tp_size", 1) or 1), 1)
    shard, nshards = shard // tp, max(nshards // tp, 1)
    train_tf = build_transforms(cfg, "train")
    valid_tf = build_transforms(cfg, "valid")
    bs = cfg.data.batch_size // nshards
    bs_val = cfg.data.batch_size_val // nshards
    workers = cfg.data.num_workers

    def train_loader(dataset):
        return DataLoader(dataset, bs, shuffle=True, drop_last=True,
                          num_workers=workers, shard_index=shard,
                          shard_count=nshards, pad_shards=True)

    sets = [CsvPairDataset(cfg, n, tokenizer, train_tf, "train")
            for n in cfg.data.train_name]
    if cfg.data.train_type == "shuffle":
        train, train_datasets = [train_loader(ConcatDataset(sets))], None
    elif cfg.data.train_type in ("sequential", "debias"):
        train, train_datasets = [train_loader(d) for d in sets], sets
    else:
        raise NotImplementedError(f"data.train_type '{cfg.data.train_type}'")

    if cfg.data.get("single_eval", True):
        vshard, vnshards, bs_val = 0, 1, cfg.data.batch_size_val
    else:
        vshard, vnshards = shard, nshards
    val = []
    if cfg.data.enable_valid:
        for name in cfg.data.valid_name:
            if os.path.exists(os.path.join(cfg.data.data_path, name,
                                           "valid.parquet")):
                ds = ParquetRetrievalDataset(cfg, name, tokenizer, valid_tf)
            else:
                ds = CsvPairDataset(cfg, name, tokenizer, valid_tf, "valid")
            val.append(DataLoader(ds, bs_val, num_workers=workers,
                                  shard_index=vshard, shard_count=vnshards,
                                  pad_shards=True))
    return dict(train=train, train_dataset=train_datasets, val=val)


def build_imagenet_dataloaders(cfg) -> Dict[str, Any]:
    """The linear probe's loaders over ``<data_path>/{train,val}`` class
    folders (JAX ``build_imagenet_dataloaders``): the train loader shuffled,
    its last short batch dropped, ``data.batch_size`` over the world with
    the shards padded; the val loader of ``data.batch_size_val``, the whole
    set on every process under ``data.single_eval`` (default), else the
    rank's padded shard of ``batch_size_val / W`` a batch."""
    shard, nshards = process_shard()
    root = cfg.data.data_path
    train_ds = ImageFolderDataset(os.path.join(root, "train"),
                                  build_transforms(cfg, "train"))
    val_ds = ImageFolderDataset(os.path.join(root, "val"),
                                build_transforms(cfg, "valid"))
    train = DataLoader(train_ds, cfg.data.batch_size // nshards, shuffle=True,
                       drop_last=True, num_workers=cfg.data.num_workers,
                       shard_index=shard, shard_count=nshards, pad_shards=True)
    if cfg.data.get("single_eval", True):
        vshard, vnshards, bs_val = 0, 1, cfg.data.batch_size_val
    else:
        vshard, vnshards = shard, nshards
        bs_val = cfg.data.batch_size_val // nshards
    val = DataLoader(val_ds, bs_val, num_workers=cfg.data.num_workers,
                     shard_index=vshard, shard_count=vnshards, pad_shards=True)
    return dict(train=[train], train_dataset=None, val=[val])
