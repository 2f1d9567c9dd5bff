"""Token merging (ToMe) for the ViT tower (port of ``simseg_tpu/ops/tome.py``).

Bipartite soft matching (Bolya et al., "Token Merging: Your ViT But
Faster"): tokens at even positions (set A, the CLS protected) match against
the odd positions (set B) by the cosine similarity of the block's attention
keys; the ``r`` A tokens with the best match merge into it as size-weighted
means. B tokens are never merged away, so no chains form and one old->new
hop suffices; the compaction keeps the original order. The tower tracks
where each original token went and unmerges after its final norm, so its
(B, 1+N, D) output keeps one row per patch (merged groups share a row).

Semantics as the JAX version, step for step: the metric normalised with
``+1e-6`` in float32, the protected rows at -inf, ties broken towards the
lowest index (``jnp.argmax`` and ``jax.lax.top_k``: ``torch.argmax`` takes
the first maximum, and a stable descending sort stands in for ``top_k``),
and the merge as one batched product with a (T, T - r) one-hot matrix in
x's dtype, sizes in float32. The product is deterministic, where an
``index_add_`` onto B tokens that receive several A tokens would add in a
different order from run to run on the card; its cost is about 2·T·(T-r)·D
operations per image and merge, 3% of a ViT-B block at T = 325.

Index maps are int64 here (``torch.gather`` wants int64; JAX keeps int32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def merge_counts(t: int, r: int, protect: int = 1) -> int:
    """Number of tokens merged at length ``t``: ``r`` clamped to the A side
    (the even positions, the protected CLS among them)."""
    na = (t + 1) // 2
    return max(0, min(int(r), na - protect))


def bipartite_merge(x: torch.Tensor, sizes: torch.Tensor,
                    metric: torch.Tensor, r: int, protect: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """Merge ``r`` token pairs. x: (B, T, D); sizes: (B, T) float32;
    metric: (B, T, M). Returns (x_new (B, T - r, D), sizes_new (B, T - r),
    old2new (B, T) int64), or (x, sizes, None) when nothing merges."""
    b, t, _ = x.shape
    r = merge_counts(t, r, protect)
    if r <= 0:
        return x, sizes, None
    na = (t + 1) // 2
    device = x.device

    m = metric.float()
    m = m / (torch.linalg.vector_norm(m, dim=-1, keepdim=True) + 1e-6)
    scores = torch.matmul(m[:, 0::2], m[:, 1::2].transpose(1, 2))  # (B, na, nb)
    if protect:
        scores[:, :protect, :] = -torch.inf
    node_max, node_dst = scores.max(dim=-1)                        # (B, na)
    src_rank = torch.sort(node_max, dim=-1, descending=True,
                          stable=True).indices[:, :r]              # (B, r)
    merged_a = torch.zeros((b, na), dtype=torch.bool, device=device)
    merged_a.scatter_(1, src_rank, True)

    # old-coordinate bookkeeping: B tokens are never merged away, so one
    # old -> new hop suffices
    a_old = torch.arange(0, t, 2, device=device)
    b_old = torch.arange(1, t, 2, device=device)
    keep = torch.ones((b, t), dtype=torch.bool, device=device)
    keep[:, 0::2] = ~merged_a
    dst_old = torch.arange(t, device=device).expand(b, t).clone()
    dst_old[:, 0::2] = torch.where(merged_a, b_old[node_dst], a_old)
    new_idx = torch.cumsum(keep.long(), dim=1) - 1
    old2new = torch.gather(new_idx, 1, dst_old)

    # one product does the compaction and the size-weighted merge (the
    # one-hot by comparison: ``F.one_hot`` checks its indices' range on the
    # host, a device sync per merge)
    onehot = old2new[..., None] == torch.arange(t - r, device=device)  # (B, T, T-r)
    w = onehot.to(x.dtype) * sizes.to(x.dtype)[..., None]
    sizes_new = torch.matmul(onehot.float().transpose(1, 2),
                             sizes.float()[..., None])[..., 0]
    x_new = torch.matmul(w.transpose(1, 2), x)
    x_new = x_new / sizes_new.to(x.dtype)[..., None]
    return x_new, sizes_new, old2new


def update_gather_map(gather_map: torch.Tensor,
                      old2new: Optional[torch.Tensor]) -> torch.Tensor:
    """Compose an original-token -> current-index map (B, T_orig) with a
    merge's old -> new map."""
    if old2new is None:
        return gather_map
    return torch.gather(old2new, 1, gather_map)


def unmerge(x: torch.Tensor, gather_map: torch.Tensor) -> torch.Tensor:
    """(B, T_cur, D) + (B, T_orig) -> (B, T_orig, D); merged groups share a
    feature row."""
    index = gather_map[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, index)


def size_bias(sizes: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Proportional attention: (B, T) sizes -> (B, 1, 1, T) additive
    log(size) on the key axis, in ``dtype`` (ToMe eq. 2)."""
    return torch.log(sizes)[:, None, None, :].to(dtype)
