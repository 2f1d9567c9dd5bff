"""Inputs drawn from ``--seed``: images of seeded scenes and caption token
ids.

Every draw takes a ``torch.Generator`` on the device it draws on, seeded
from the run's seed and a tag of its own, so the same seed gives the same
inputs and the draws do not share a stream. Every seed gives the same
sizes of work: the image sizes, the region counts, the caption lengths'
distribution are the traffic's, only their content
moves with the seed.
"""

from __future__ import annotations

from typing import Dict, List

import torch

# the draws' tags
TAG_WEIGHTS, TAG_POOL = 1, 4

# BERT's special token ids (bert-base-uncased's vocabulary; padding is 0)
CLS_ID, SEP_ID = 101, 102
# caption words take ids from here up to the vocabulary's end
WORD_LO = 1000


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A generator on ``device`` for one kind of draw of run ``seed``."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed {seed} < 0")
    return torch.Generator(device=device).manual_seed((seed << 4) | tag)


def _uniform(gen, shape, device, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def _randint(gen, lo, hi, shape, device):
    return torch.randint(lo, hi, shape, generator=gen, device=device)


class Scenes:
    """Seeded scenes of flat regions and their edges: each image a Voronoi
    tiling of ``regions`` sites in the unit square, each region a class
    drawn from ``num_classes`` painted in that class's palette colour with
    a jitter of its own, the edges between regions darkened, and pixel
    noise on top."""

    def __init__(self, gen, device, b: int, num_classes: int, regions: int):
        self.b, self.device = b, device
        self.sites = _uniform(gen, (b, regions, 2), device)
        self.cls = _randint(gen, 0, num_classes, (b, regions), device)
        palette = _uniform(gen, (num_classes, 3), device, 20.0, 235.0)
        self.colour = (palette[self.cls]
                       + torch.randn((b, regions, 3), generator=gen,
                                     device=device) * 10.0)
        self.gen = gen

    def _nearest(self, i: int, h: int, w: int):
        ys = (torch.arange(h, device=self.device, dtype=torch.float32) + 0.5) / h
        xs = (torch.arange(w, device=self.device, dtype=torch.float32) + 0.5) / w
        grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), -1)
        d = torch.cdist(grid.reshape(-1, 2), self.sites[i])       # (hw, R)
        two = torch.topk(d, 2, dim=1, largest=False)
        edge = (two.values[:, 1] - two.values[:, 0]).reshape(h, w)
        return two.indices[:, 0].reshape(h, w), edge

    def images(self, size: int) -> torch.Tensor:
        """(b, size, size, 3) uint8 on the device."""
        out = torch.empty((self.b, size, size, 3), dtype=torch.uint8,
                          device=self.device)
        for i in range(self.b):
            idx, edge = self._nearest(i, size, size)
            img = self.colour[i][idx]
            img = torch.where((edge < 2.0 / size)[..., None], img * 0.45, img)
            img = img + torch.randn(img.shape, generator=self.gen,
                                    device=self.device) * 5.0
            out[i] = img.round().clamp(0, 255).to(torch.uint8)
        return out



def _host(t: torch.Tensor) -> torch.Tensor:
    """A copy in host memory, pinned where it came from the card (so the
    batch's copy to the card reads pinned pages, as a prefetching loader's
    does)."""
    return t.cpu().pin_memory() if t.is_cuda else t.cpu()


def caption_ids(gen, device, b: int, length: int, vocab: int,
                min_len: int) -> Dict[str, torch.Tensor]:
    """(b, length) int64 caption ids and their attention mask: [CLS], words
    drawn from the ordinary words' ids, [SEP], then padding; each caption's
    length (with [CLS] and [SEP]) uniform in [min_len, length]."""
    lens = _randint(gen, min_len, length + 1, (b, 1), device)
    pos = torch.arange(length, device=device)[None, :]
    words = _randint(gen, min(WORD_LO, vocab // 2), vocab, (b, length), device)
    ids = torch.where(pos == 0, CLS_ID, words)
    ids = torch.where(pos == lens - 1, SEP_ID, ids)
    mask = (pos < lens).to(torch.int64)
    return {"input_ids": ids * mask, "attention_mask": mask}


def train_pool(seed: int, device, pool: int, batch: int, size: int,
               length: int, vocab: int, min_len: int, regions: int
               ) -> List[Dict[str, torch.Tensor]]:
    """``pool`` distinct training batches in pinned host memory: uint8
    images (B, size, size, 3) of seeded scenes and caption ids."""
    gen = generator(seed, TAG_POOL, device)
    out = []
    for _ in range(pool):
        scenes = Scenes(gen, device, batch, 16, regions)
        batch_d = {"image": scenes.images(size),
                   **caption_ids(gen, device, batch, length, vocab, min_len)}
        out.append({k: _host(v)
                    for k, v in batch_d.items()})
    return out
