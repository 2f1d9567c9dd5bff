"""Image-text retrieval metrics: R@1/5/10 and RSUM (port of
``simseg_tpu/utils/retrieval.py``).

Parity: reference ``simseg/tasks/clip/hooks/utils.py:8-75``: embeddings
grouped by id (one per image id), the full similarity matrix, recall@k
from the rank of the first match. The rank of a row's first match is the
count of gallery scores above its best matching score, which is what an
argsort of the row gives for the first match; it takes one float32
``torch.matmul`` per chunk of 4096 rows and elementwise work, on the
embeddings' device (numpy inputs: the CPU). TF32 must be off for the
products to be float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def _tensor(x: Array) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


@dataclass
class IndexedEmb:
    name: str
    group_idx: np.ndarray  # (N,) ids on the host
    emb: torch.Tensor      # (N, D) on any device

    def unique(self) -> "IndexedEmb":
        """One embedding per group id: the last occurrence after a stable
        sort (parity: unique_consecutive + cumsum offsets, hooks/utils.py:14-19)."""
        order = np.argsort(self.group_idx, kind="stable")
        uni, counts = np.unique(self.group_idx[order], return_counts=True)
        rows = torch.from_numpy(order[np.cumsum(counts) - 1]).to(self.emb.device)
        return IndexedEmb(self.name, uni, self.emb[rows])


def first_match_ranks(left: IndexedEmb, right: IndexedEmb,
                      batch: int = 4096) -> np.ndarray:
    """For each left row, the 0-based rank of the first right entry with its
    group id when the rights are sorted by similarity, descending; -1 where
    no right entry matches."""
    device = left.emb.device
    l_emb = left.emb.float()
    r_emb = right.emb.to(device).float()
    l_gid = torch.from_numpy(np.asarray(left.group_idx)).to(device)
    r_gid = torch.from_numpy(np.asarray(right.group_idx)).to(device)
    out = []
    for start in range(0, l_emb.shape[0], batch):
        sim = torch.matmul(l_emb[start:start + batch], r_emb.T)
        match = l_gid[start:start + batch, None] == r_gid[None, :]
        best = torch.where(match, sim, -torch.inf).amax(dim=1)
        # every entry ahead of the first match scores above the best match
        rank = (sim > best[:, None]).sum(dim=1)
        out.append(torch.where(match.any(dim=1), rank, -1).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), np.int64)


def recall_at_k(left: IndexedEmb, right: IndexedEmb,
                ks: Sequence[int] = (1, 5, 10)) -> Dict[str, float]:
    """R@k for left -> right retrieval (parity: RetrievalMetric.__call__)."""
    ranks = first_match_ranks(left, right)
    valid = ranks >= 0
    assert valid.sum() > 0
    return {f"R@{k}": float(((ranks >= 0) & (ranks < k)).sum() / valid.sum())
            for k in ks}


def retrieval_summary(image_emb: Array, text_emb: Array, image_ids: Array,
                      caption_ids: Array) -> Dict[str, float]:
    """The image-to-text and text-to-image tables and RSUM (parity:
    tasks/clip/hooks/eval.py:39-81): images deduplicated by id; a caption
    matches the image id it describes. Embeddings as tensors stay on their
    device; ids on the host."""
    image_ids = np.asarray(_tensor(image_ids).cpu())
    text = _tensor(text_emb)
    img = IndexedEmb("image", image_ids, _tensor(image_emb)).unique()
    txt_for_match = IndexedEmb("text", image_ids, text)
    i2t = recall_at_k(img, txt_for_match)
    t2i = recall_at_k(txt_for_match, img)
    result = {f"i2t_{k}": v for k, v in i2t.items()}
    result.update({f"t2i_{k}": v for k, v in t2i.items()})
    result["rsum"] = 100.0 * (sum(i2t.values()) + sum(t2i.values()))
    return result
