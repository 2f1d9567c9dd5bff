"""PyTorch port (simseg_tpu_torch): the CLIP pair data path — caption
corruption, the CSV and parquet datasets, the train loader's options and
``build_clip_dataloaders`` in its three train modes — against the JAX
package's (``simseg_tpu/data/{corruption,datasets}.py``) on the same files.

Bar: exact. Captions equal as strings; token ids and id columns equal;
images bit-equal (JAX on ``data.native_decode=False``, its PIL path, under
the same ``random.seed``). The port's loader yields images as uint8 CPU
tensors where JAX's yields numpy.
"""

import random
import unittest.mock

import numpy as np
import pytest
import torch
from PIL import Image

import simseg_tpu.data.datasets as jax_ds
from simseg_tpu.config import new_base_cfg as jax_new_base_cfg
from simseg_tpu.config import update_cfg as jax_update_cfg
from simseg_tpu.data.corruption import process_caption as jax_process_caption
from simseg_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from simseg_tpu.data.transforms import build_transforms as jax_build_transforms
from simseg_tpu.tasks.clip.config import task_cfg_init_fn as jax_task_cfg_init_fn
import simseg_tpu_torch.data.datasets as ds
from simseg_tpu_torch.config import new_base_cfg, update_cfg
from simseg_tpu_torch.data.corruption import process_caption
from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
from simseg_tpu_torch.data.transforms import build_transforms
from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn

torch.set_num_threads(1)

WORDS = ["a", "photo", "of", "the", "dog", "cat", "play", "##ing", "##s",
         "red", "car", "on", "street", "man", "with", "hat", "café", "über",
         "##er", "run", "##ner"]
# captions with what pandas' reader must get right: quoted commas and
# doubled quotes, a line break inside quotes, non-ASCII text
CAPTIONS = ["a photo of the dog", 'the "red" car, on the street',
            "a man with a hat, playing", "café runner\nwith dogs",
            "über cats playing with a red car", "a, b, c",
            'he said "run", the cat ran']


def tokenizers():
    vocab = make_test_vocab(WORDS)
    return WordPieceTokenizer(vocab), JaxTokenizer(dict(vocab))


def write_pair_set(root, name, n_train, n_valid, seed, parquet=False):
    """``<root>/<name>/{train,valid}_anno.csv`` (csv-module quoting) and
    the images (JPEG and PNG by PIL, 40-90 px); with ``parquet`` also
    ``<name>/valid.parquet`` of the valid rows."""
    import csv

    rng = np.random.default_rng(seed)
    base = root / name
    rows_by_split = {}
    for split, n in (("train", n_train), ("valid", n_valid)):
        (base / split).mkdir(parents=True)
        rows = []
        for i in range(n):
            h, w = (int(v) for v in rng.integers(40, 91, 2))
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            fname = f"{split}_{i}.{'png' if i % 3 == 0 else 'jpg'}"
            Image.fromarray(img).save(base / split / fname)
            rows.append([fname, CAPTIONS[(i + seed) % len(CAPTIONS)],
                         str(i // 2), str(100 + i)])
        with open(base / f"{split}_anno.csv", "w", newline="",
                  encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(["image", "caption", "image_id", "caption_id"])
            writer.writerows(rows)
        rows_by_split[split] = rows
    if parquet:
        import pandas as pd

        pd.DataFrame([{"imbytes": (base / "valid" / r[0]).read_bytes(),
                       "caption": r[1], "image_id": int(r[2]),
                       "id": int(r[3])} for r in rows_by_split["valid"]]
                     ).to_parquet(base / "valid.parquet")


TINY = ["transforms.input_size=32", "transforms.resize.size=32",
        "transforms.random_resize_crop.size=32", "model.max_length=12",
        "data.native_decode=False", "data.num_workers=1", "seed=3"]


def cfgs(root, *argv):
    argv = TINY + [f"data.data_path={root}/"] + list(argv)
    return (update_cfg(task_cfg_init_fn, None, argv=argv, target=new_base_cfg()),
            jax_update_cfg(jax_task_cfg_init_fn, None, argv=argv,
                           target=jax_new_base_cfg()))


def assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == want[k].dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


# -------------------------------------------------------------- corruption

def test_process_caption_matches_jax():
    port_tok, jax_tok = tokenizers()
    words = [w for w in WORDS if not w.startswith("##")]
    rng = np.random.default_rng(0)
    texts = list(CAPTIONS)
    for _ in range(20):
        n = int(rng.integers(1, 16))
        texts.append(" ".join(rng.choice(words + ["playing", "runners", "zq",
                                                  "dogs", ",", "!"], n)))
    cases = 0
    changed = 0
    for t, text in enumerate(texts):
        for seed in range(4):
            for epoch in range(4):
                key = (seed * 1_000_003 + epoch) * 1_000_003 + t
                want = jax_process_caption(jax_tok, text, rng=random.Random(key))
                got = process_caption(port_tok, text, rng=random.Random(key))
                assert got == want, (text, seed, epoch)
                changed += got != process_caption(port_tok, text, train=False)
                cases += 1
    assert cases >= 300 and changed > cases // 4
    # the module-level generator, as JAX's default
    random.seed(5)
    want = [jax_process_caption(jax_tok, c) for c in CAPTIONS]
    random.seed(5)
    assert [process_caption(port_tok, c) for c in CAPTIONS] == want


# ---------------------------------------------------------------- datasets

def test_csv_columns_match_pandas(tmp_path):
    import pandas as pd

    write_pair_set(tmp_path, "set", 9, 4, seed=1)
    path = tmp_path / "set" / "train_anno.csv"
    # a BOM and CRLF line ends, as spreadsheet exports write them
    (tmp_path / "bom.csv").write_bytes(
        b"\xef\xbb\xbf" + path.read_bytes().replace(b"\n", b"\r\n")
        .replace(b"\r\r\n", b"\r\n") + b"\r\n")
    for p in (path, tmp_path / "bom.csv"):
        cols = ds.read_csv_columns(str(p))
        df = pd.read_csv(p)
        assert list(cols) == list(df.columns)
        assert cols["image"] == df["image"].tolist()
        assert cols["caption"] == df["caption"].tolist()
        assert [int(v) for v in cols["image_id"]] == df["image_id"].tolist()
    assert any("\n" in c for c in cols["caption"])
    assert any('"red"' in c for c in cols["caption"])


@pytest.mark.parametrize("mode", ["train", "valid"])
def test_csv_pair_dataset_matches_jax(tmp_path, mode):
    write_pair_set(tmp_path, "set", 10, 7, seed=2)
    port_tok, jax_tok = tokenizers()
    cfg, jcfg = cfgs(tmp_path)
    port = ds.CsvPairDataset(cfg, "set", port_tok, build_transforms(cfg, mode),
                             mode)
    ref = jax_ds.CsvPairDataset(jcfg, "set", jax_tok,
                                jax_build_transforms(jcfg, mode), mode)
    assert len(port) == len(ref)
    assert port.captions == ref.captions and port.image_ids == ref.image_ids
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            random.seed(i)
            want = ref[i]
            random.seed(i)
            got = port[i]
            assert isinstance(got["image"], torch.Tensor)
            assert got["image"].device.type == "cpu"
            assert_batches_equal(ds._collate([got]), jax_ds._collate([want]))


def test_parquet_dataset_matches_jax(tmp_path):
    write_pair_set(tmp_path, "f30k", 0, 6, seed=3, parquet=True)
    port_tok, jax_tok = tokenizers()
    cfg, jcfg = cfgs(tmp_path)
    port = ds.ParquetRetrievalDataset(cfg, "f30k", port_tok,
                                      build_transforms(cfg, "valid"))
    ref = jax_ds.ParquetRetrievalDataset(jcfg, "f30k", jax_tok,
                                         jax_build_transforms(jcfg, "valid"))
    assert len(port) == len(ref) == 6
    assert_batches_equal(ds._collate([port[i] for i in range(6)]),
                         jax_ds._collate([ref[i] for i in range(6)]))


def test_parquet_without_pyarrow_names_it(tmp_path):
    write_pair_set(tmp_path, "f30k", 0, 2, seed=3, parquet=True)
    cfg, _ = cfgs(tmp_path)
    with unittest.mock.patch.dict("sys.modules", {"pyarrow": None,
                                                  "pyarrow.parquet": None}):
        with pytest.raises(ImportError, match="pyarrow"):
            ds.ParquetRetrievalDataset(cfg, "f30k", tokenizers()[0], None)


# ------------------------------------------------------------------ loader

class _Ids:
    """A dataset of its indices, with the epoch it was told."""

    def __init__(self, n):
        self.n, self.epoch = n, None

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __getitem__(self, i):
        return {"i": np.int64(i)}


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shards", [(0, 1, False), (1, 3, False), (2, 3, True),
                                    (0, 4, True)])
def test_loader_order_matches_jax(shuffle, drop_last, shards):
    shard, count, pad = shards
    kw = dict(shuffle=shuffle, drop_last=drop_last, shard_index=shard,
              shard_count=count, pad_shards=pad, seed=7, num_workers=2)
    for n in (0, 1, 10, 23):
        port, ref = ds.DataLoader(_Ids(n), 4, **kw), jax_ds.DataLoader(_Ids(n), 4, **kw)
        for epoch in (0, 1, 2):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert port.dataset.epoch == epoch
            got = [b["i"].tolist() for b in port]
            assert got == [b["i"].tolist() for b in ref]
            assert len(port) == len(ref) == len(got)


def test_concat_and_mixing_match_jax():
    sets = [_Ids(5), _Ids(8)]
    cat, jcat = ds.ConcatDataset(sets), jax_ds.ConcatDataset(sets)
    assert [cat[i]["i"] for i in range(13)] == [jcat[i]["i"] for i in range(13)]
    cat.set_epoch(4)
    assert [d.epoch for d in sets] == [4, 4]
    for seed in range(5):
        loaders = [ds.DataLoader(_Ids(n), 2) for n in (5, 8, 3)]
        jloaders = [jax_ds.DataLoader(_Ids(n), 2) for n in (5, 8, 3)]
        assert ([b["i"].tolist() for b in ds.debias_batches(loaders, seed)]
                == [b["i"].tolist() for b in jax_ds.debias_batches(jloaders, seed)])
    assert ([b["i"].tolist() for b in ds.sequential_batches(loaders)]
            == [b["i"].tolist() for b in jax_ds.sequential_batches(jloaders)])


# ----------------------------------------------------- build_clip_dataloaders

MODES = {
    # JAX's default pair: random train ops with one decode thread, so that
    # the module-level random is drawn in one order
    "shuffle": ["data.train_type=shuffle",
                "transforms.train_transforms=[random_resize_crop,autoaug]"],
    "sequential": ["data.train_type=sequential",
                   "transforms.train_transforms=[random_resize_crop,autoaug]"],
    # debias starts every loader's producer at once: their draws from the
    # shared random interleave by thread timing in both packages, so the
    # train ops here draw nothing
    "debias": ["data.train_type=debias", "transforms.train_transforms=[resize]"],
}


def _epoch(loaders, mode, epoch, mixing, seed):
    for loader in loaders:
        loader.set_epoch(epoch)
    random.seed(seed)
    if mode == "shuffle":
        return list(loaders[0])
    if mode == "sequential":
        return list(mixing.sequential_batches(loaders))
    return list(mixing.debias_batches(loaders, seed=epoch))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_build_clip_dataloaders_matches_jax(tmp_path, mode, shard):
    """Two train sets and a CSV and a parquet valid set; the batches of two
    epochs and of the valid loaders equal to JAX's, one for one; with
    ``shard``, this process is rank 1 of 2 (drop_last, wrap-padded shards,
    half the batch)."""
    write_pair_set(tmp_path, "a", 13, 5, seed=4)
    write_pair_set(tmp_path, "b", 9, 0, seed=5)
    write_pair_set(tmp_path, "f30k", 0, 6, seed=6, parquet=True)
    argv = MODES[mode] + ["data.train_name=[a,b]", "data.valid_name=[a,f30k]",
                          "data.batch_size=4", "data.batch_size_val=4",
                          "data.single_eval=False"]
    cfg, jcfg = cfgs(tmp_path, *argv)
    port_tok, jax_tok = tokenizers()
    with unittest.mock.patch.object(ds, "process_shard", lambda: shard or (0, 1)), \
            unittest.mock.patch.object(jax_ds, "_process_shard",
                                       lambda: shard or (0, 1)):
        port = ds.build_clip_dataloaders(cfg, port_tok)
        ref = jax_ds.build_clip_dataloaders(jcfg, jax_tok)
    assert len(port["train"]) == len(ref["train"])
    assert (port["train_dataset"] is None) == (ref["train_dataset"] is None)
    assert [len(l) for l in port["train"]] == [len(l) for l in ref["train"]]
    for epoch in (0, 1):
        want = _epoch(ref["train"], mode, epoch, jax_ds, 11 + epoch)
        got = _epoch(port["train"], mode, epoch, ds, 11 + epoch)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["image"].shape[0] == (2 if shard else 4)
            assert_batches_equal(g, w)
    assert [type(l.dataset).__name__ for l in port["val"]] == [
        "CsvPairDataset", "ParquetRetrievalDataset"]
    for pl, jl in zip(port["val"], ref["val"]):
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == len(pl)
        for g, w in zip(got, want):
            assert_batches_equal(g, w)


def test_build_clip_dataloaders_needs_a_tokenizer(tmp_path):
    write_pair_set(tmp_path, "a", 2, 0, seed=4)
    cfg, _ = cfgs(tmp_path, "data.train_name=[a]", "data.enable_valid=False")
    with pytest.raises(ValueError, match="vocab_file"):
        ds.build_clip_dataloaders(cfg)
    with pytest.raises(NotImplementedError, match="train_type"):
        ds.build_clip_dataloaders(cfgs(tmp_path, "data.train_name=[a]",
                                       "data.train_type=mixed")[0],
                                  tokenizers()[0])
