"""Inputs and weights follow the seed: the same seed gives the same
arrays, another seed other contents of the same sizes; seeds past 32 bits
work."""

import pytest
import torch

from pbench import data, weights
from pbench_ref.clip import param_shapes
from conftest import HERE, read
import os

BIG = 2 ** 31 + 12345


def test_train_pool_and_captions():
    a = data.train_pool(BIG, "cpu", 2, 4, 24, 25, 30522, 6, 4)
    b = data.train_pool(BIG, "cpu", 2, 4, 24, 25, 30522, 6, 4)
    c = data.train_pool(BIG + 1, "cpu", 2, 4, 24, 25, 30522, 6, 4)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert all(x[k].shape == z[k].shape and x[k].dtype == z[k].dtype
               for x, z in zip(a, c) for k in x)
    assert not torch.equal(a[0]["image"], c[0]["image"])
    img = a[0]["image"]
    assert img.dtype == torch.uint8 and img.shape == (4, 24, 24, 3)
    # regions and edges, not noise: most pixels are close to a neighbour
    near = ((img[:, 1:].float() - img[:, :-1].float()).abs() < 30).float().mean()
    assert near > 0.8
    ids, mask = a[0]["input_ids"], a[0]["attention_mask"]
    assert (ids[:, 0] == data.CLS_ID).all()
    lens = mask.sum(1)
    assert ((lens >= 6) & (lens <= 25)).all()
    for row, n in zip(ids, lens):
        assert row[n - 1] == data.SEP_ID and (row[n:] == 0).all()


def test_weights_are_fixed_by_the_seed():
    sizes = read(os.path.join(HERE, "data", "configs", "tiny.json"))["sizes"]
    shapes = param_shapes(sizes)
    a = weights.make_state(shapes, BIG, "cpu", 0.02)
    b = weights.make_state(shapes, BIG, "cpu", 0.02)
    c = weights.make_state(shapes, BIG + 1, "cpu", 0.02)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["image_projection.linear.weight"], c["image_projection.linear.weight"])
    assert float(a["loss.temperature"]) == pytest.approx(0.02)
    ln = a["image_encoder.model.model.norm.weight"]
    assert abs(float(ln.mean()) - 1.0) < 0.05
    words = a["text_encoder.model.model.embeddings.word_embeddings.weight"]
    assert abs(float(words.std()) - weights.STD) < 0.1 * weights.STD
