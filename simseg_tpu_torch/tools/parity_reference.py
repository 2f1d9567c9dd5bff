"""The reference side of the production-settings parity harness
(``tools/seg_parity.py``): an independent torch + numpy re-derivation of
the reference eval loop (reference ``tools/seg_evaluation.py:78-181``) with
an *exact* mean-field dense CRF, on synthetic palette scenes.

It is the yardstick the port is measured against, so it always runs on the
host in float32 (towers) and float64 (CRF), and it shares no code with the
port's decode: the towers are plain ``nn.Module`` re-implementations of the
reference layouts (timm ViT, HF BERT, SimSeg projections), the CRF is the
exact one below, and OpenCV's 7x7 closing and nearest resize are numpy code
that reproduces cv2's border and index rules bit for bit.

Exact dense CRF for palette-limited images: for pixel i with colour c_i the
bilateral message factorises over the palette,

    m(i) = sum_j exp(-|p_i-p_j|^2/2sxy^2) exp(-|c_i-c_j|^2/2srgb^2) x(j)
         = sum_v exp(-|c_i-c_v|^2/2srgb^2) * [G_sxy * (x * 1{c=v})](p_i)

one exact full-extent spatial Gaussian convolution (FFT) per palette
colour, O(K N log N) for a K-colour image, against O(N^2) in general.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from simseg_tpu_torch.utils.prompts import openai_imagenet_template

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)

# --------------------------------------------------------------------------
# Exact dense CRF for palette-limited images (numpy, FFT)
# --------------------------------------------------------------------------


def _full_gaussian_fft(h: int, w: int, sigma: float, fh: int, fw: int):
    """rfft2 of the full-extent (untruncated) 2-D Gaussian kernel
    exp(-0.5 d^2 / sigma^2) over all offsets (+-(h-1), +-(w-1)), zero-padded
    to (fh, fw) and rolled so the kernel centre sits at the origin."""
    dy = np.arange(-(h - 1), h, dtype=np.float64)
    dx = np.arange(-(w - 1), w, dtype=np.float64)
    k = np.exp(-0.5 * (dy[:, None] ** 2 + dx[None, :] ** 2) / sigma**2)
    pad = np.zeros((fh, fw), np.float64)
    pad[: 2 * h - 1, : 2 * w - 1] = k
    pad = np.roll(pad, (-(h - 1), -(w - 1)), axis=(0, 1))
    return np.fft.rfft2(pad)


class _FFTConv:
    """'Same'-extent linear convolution with a full-extent Gaussian via a
    zero-padded FFT: the brute-force kernel-matrix product with
    exp(-0.5 |p_i - p_j|^2 / sigma^2), to float64 rounding."""

    def __init__(self, h: int, w: int, sigma: float):
        # a linear convolution of (h, w) with a (2h-1, 2w-1) kernel needs
        # >= 3h-2 rows
        from scipy.fft import next_fast_len

        self.h, self.w = h, w
        self.fh = next_fast_len(3 * h - 2)
        self.fw = next_fast_len(3 * w - 2)
        self.kfft = _full_gaussian_fft(h, w, sigma, self.fh, self.fw)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """x: (..., h, w) -> (..., h, w)."""
        lead = x.shape[:-2]
        xp = np.zeros(lead + (self.fh, self.fw), np.float64)
        xp[..., : self.h, : self.w] = x
        y = np.fft.irfft2(np.fft.rfft2(xp) * self.kfft, s=(self.fh, self.fw))
        return y[..., : self.h, : self.w]


def exact_dense_crf_palette(
    probs: np.ndarray,
    rgb: np.ndarray,
    iters: int = 3,
    g_sxy: float = 3.0,
    g_compat: float = 3.0,
    b_sxy: float = 40.0,
    b_srgb: float = 13.0,
    b_compat: float = 10.0,
    color_chunk: int = 8,
    _shared=None,
) -> np.ndarray:
    """Exact 2-label mean-field dense CRF (Kraehenbuehl, symmetric kernel
    normalisation, self-interaction included) in O(K N log N) for a
    K-colour palette image.

    probs: (H, W) foreground probability; rgb: (H, W, 3) 0..255.
    Returns the (H, W) int argmax mask.

    _shared: the per-image state of :func:`crf_image_state` (palette,
    kernels and normalisations are class-independent, so a caller refining
    several candidate classes of one image builds it once).
    """
    h, w = probs.shape
    st = _shared if _shared is not None else crf_image_state(
        rgb, g_sxy=g_sxy, b_sxy=b_sxy, b_srgb=b_srgb, color_chunk=color_chunk,
        shape=(h, w),
    )

    p = probs.astype(np.float64)
    u = -np.log(np.stack([1.0 - p, p], 0) + 1e-8)  # (2, H, W)

    def softmax2(x):
        e = np.exp(x - x.max(0, keepdims=True))
        return e / e.sum(0, keepdims=True)

    q = softmax2(-u)
    for _ in range(iters):
        # both channels' messages from channel 0's convolution: q1 = 1 - q0
        # and the kernels are linear, so m1 = n K(n) - m0, where n K(n) is
        # the class-independent degree term of the state
        mg0 = st["ng"] * st["gconv"](st["ng"] * q[0])
        mb0 = st["nb"] * st["bilateral"](st["nb"] * q[0])
        m0 = g_compat * mg0 + b_compat * mb0
        m1 = (g_compat * st["g_total"] + b_compat * st["b_total"]) - m0
        q = softmax2(-u + np.stack([m0, m1], 0))
    return np.argmax(q, 0)


def crf_image_state(rgb: np.ndarray, g_sxy: float = 3.0, b_sxy: float = 40.0,
                    b_srgb: float = 13.0, color_chunk: int = 8,
                    shape=None) -> dict:
    """Class-independent exact-CRF state of one palette image: the palette
    decomposition, the FFT kernels, the symmetric normalisations and the
    n K(n) degree fields of the two-channel identity."""
    h, w = shape if shape is not None else rgb.shape[:2]
    flat = rgb.reshape(-1, 3).astype(np.float64)
    colors, inv = np.unique(flat, axis=0, return_inverse=True)
    kcol = len(colors)
    inv = inv.reshape(h, w)
    # colour-kernel weights between palette entries
    cdist = ((colors[:, None, :] - colors[None, :, :]) ** 2).sum(-1)
    wc = np.exp(-0.5 * cdist / b_srgb**2)  # (K, K)

    gconv = _FFTConv(h, w, g_sxy)
    bconv = _FFTConv(h, w, b_sxy)
    onehot = np.stack([inv == v for v in range(kcol)]).astype(np.float64)

    def bilateral(x: np.ndarray) -> np.ndarray:
        """x: (h, w) -> the exact bilateral-kernel product (h, w)."""
        out_per_color = np.empty((kcol, h, w), np.float64)
        for s in range(0, kcol, color_chunk):
            e = min(s + color_chunk, kcol)
            out_per_color[s:e] = bconv(x[None] * onehot[s:e])
        # m(i) = sum_v wc[c_i, v] * conv_v(i)
        mixed = np.einsum("av,vhw->ahw", wc, out_per_color)
        return np.take_along_axis(
            mixed.reshape(kcol, -1), inv.reshape(1, -1), axis=0
        ).reshape(h, w)

    ones = np.ones((h, w), np.float64)
    ng = 1.0 / np.sqrt(gconv(ones) + 1e-20)
    nb = 1.0 / np.sqrt(bilateral(ones) + 1e-20)
    return dict(
        gconv=gconv, bilateral=bilateral, ng=ng, nb=nb,
        g_total=ng * gconv(ng), b_total=nb * bilateral(nb),
    )


# --------------------------------------------------------------------------
# OpenCV's closing and nearest resize, in numpy
# --------------------------------------------------------------------------


def _window_reduce(x: np.ndarray, k: int, reduce, border) -> np.ndarray:
    """``reduce`` (np.maximum / np.minimum) over every k x k window centred
    on a pixel (anchor k // 2), the window's part outside the image taken
    as ``border``: a square window is the row pass after the column pass."""
    r = k // 2
    h, w = x.shape
    p = np.pad(x, r, constant_values=border)
    cols = reduce.reduce([p[i:i + h] for i in range(k)])
    return reduce.reduce([cols[:, j:j + w] for j in range(k)])


def closing(mask_u8: np.ndarray, k: int = 7) -> np.ndarray:
    """``cv2.erode(cv2.dilate(m, ones((k, k))), ones((k, k)))`` on a uint8
    map: cv2's default border (``morphologyDefaultBorderValue``) takes the
    type's minimum for the dilation and its maximum for the erosion, so
    pixels outside the image never win."""
    m = _window_reduce(mask_u8, k, np.maximum, 0)
    return _window_reduce(m, k, np.minimum, 255)


def resize_nearest(m: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(m, (out_w, out_h), interpolation=cv2.INTER_NEAREST)``:
    OpenCV's ``resizeNN`` reads source index min(floor(x * (1 / (out_w /
    w))), w - 1) in float64, and the same for rows."""
    h, w = m.shape[:2]
    sx = np.floor(np.arange(out_w, dtype=np.float64) * (1.0 / (out_w / w)))
    sy = np.floor(np.arange(out_h, dtype=np.float64) * (1.0 / (out_h / h)))
    sx = np.minimum(sx.astype(np.int64), w - 1)
    sy = np.minimum(sy.astype(np.int64), h - 1)
    return m[sy[:, None], sx[None, :]]


# --------------------------------------------------------------------------
# Synthetic palette-limited photo-like scenes
# --------------------------------------------------------------------------

# a fixed palette: per class a base colour and two dithered shades (the
# dithering keeps the bilateral term non-trivial without growing the palette)
_BASE_COLORS = np.array([
    [95, 110, 100],    # background: muted green-grey
    [200, 60, 50],     # class 1: red
    [40, 70, 200],     # class 2: blue
    [230, 200, 60],    # class 3: yellow
    [60, 180, 90],     # class 4: green
    [170, 60, 180],    # class 5: purple
    [240, 140, 40],    # class 6: orange
    [70, 200, 210],    # class 7: cyan
    [150, 100, 60],    # class 8: brown
    [220, 220, 225],   # class 9: near-white
    [120, 140, 200],   # class 10: slate
    [30, 30, 35],      # class 11: near-black
], np.int32)
_SHADE_DELTAS = np.array([0, -18, 14], np.int32)


def class_palette(cls: int) -> np.ndarray:
    """The (3, 3) uint8 colours of class ``cls``: its base and two shades."""
    base = _BASE_COLORS[cls % len(_BASE_COLORS)]
    return np.clip(base[None, :] + _SHADE_DELTAS[:, None], 0, 255).astype(np.uint8)


def render_scene(rng: np.random.Generator, size: int, gt_size, n_classes: int,
                 max_objects: int = 4):
    """One photo-like palette scene: (image (size, size, 3) uint8, label
    (gh, gw) uint8). Shapes are drawn analytically in relative coordinates,
    so the image and the differently sized GT label describe one scene."""
    gh, gw = gt_size
    # distinct foreground classes, at most the non-background classes
    cap = min(max_objects, n_classes - 1)
    n_obj = int(rng.integers(min(2, cap), cap + 1))
    classes = rng.choice(np.arange(1, n_classes), size=n_obj, replace=False)
    shapes = []
    for cls in classes:
        cy, cx = rng.uniform(0.2, 0.8, 2)
        ry, rx = rng.uniform(0.08, 0.28, 2)
        ang = rng.uniform(0, np.pi)
        shapes.append((int(cls), cy, cx, ry, rx, ang))

    def paint(hh, ww, with_colors):
        yy, xx = np.mgrid[0:hh, 0:ww]
        fy = (yy + 0.5) / hh
        fx = (xx + 0.5) / ww
        label = np.zeros((hh, ww), np.uint8)
        for cls, cy, cx, ry, rx, ang in shapes:
            ca, sa = np.cos(ang), np.sin(ang)
            u = (fy - cy) * ca + (fx - cx) * sa
            v = -(fy - cy) * sa + (fx - cx) * ca
            label[(u / ry) ** 2 + (v / rx) ** 2 < 1.0] = cls
        if not with_colors:
            return label, None
        img = np.empty((hh, ww, 3), np.uint8)
        shade = rng.choice(len(_SHADE_DELTAS), size=(hh, ww),
                           p=[0.7, 0.15, 0.15])
        for cls in np.unique(label):
            pal = class_palette(int(cls))
            m = label == cls
            img[m] = pal[shade[m]]
        return label, img

    _, image = paint(size, size, True)
    label, _ = paint(gh, gw, False)
    return image, label


# --------------------------------------------------------------------------
# The reference towers: timm ViT, HF BERT, SimSeg projections
# --------------------------------------------------------------------------


class TorchViTBlock(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, dim * 3)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, dim * 4)
        self.mlp.fc2 = nn.Linear(dim * 4, dim)
        self.heads = heads

    def forward(self, x):
        b, t, d = x.shape
        h = self.heads
        y = self.norm1(x)
        qkv = self.attn.qkv(y).reshape(b, t, 3, h, d // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        att = (q @ k.transpose(-2, -1)) / math.sqrt(d // h)
        att = att.softmax(-1)
        y = (att @ v).transpose(1, 2).reshape(b, t, d)
        x = x + self.attn.proj(y)
        y = self.norm2(x)
        y = self.mlp.fc2(F.gelu(self.mlp.fc1(y)))
        return x + y


class TorchViT(nn.Module):
    """timm-layout ViT; the forward returns the whole token sequence
    (reference ``vit_builder.py:13-21``)."""

    def __init__(self, img_size=32, patch=8, dim=32, depth=2, heads=2):
        super().__init__()
        n = (img_size // patch) ** 2
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + n, dim))
        self.blocks = nn.ModuleList([TorchViTBlock(dim, heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):  # x: (B, 3, H, W)
        x = self.patch_embed.proj(x)
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


class TorchBertLayer(nn.Module):
    def __init__(self, dim, heads, inter):
        super().__init__()
        self.attention = nn.Module()
        self.attention.self = nn.Module()
        self.attention.self.query = nn.Linear(dim, dim)
        self.attention.self.key = nn.Linear(dim, dim)
        self.attention.self.value = nn.Linear(dim, dim)
        self.attention.output = nn.Module()
        self.attention.output.dense = nn.Linear(dim, dim)
        self.attention.output.LayerNorm = nn.LayerNorm(dim, eps=1e-12)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(dim, inter)
        self.output = nn.Module()
        self.output.dense = nn.Linear(inter, dim)
        self.output.LayerNorm = nn.LayerNorm(dim, eps=1e-12)
        self.heads = heads

    def forward(self, x, bias):
        b, t, d = x.shape
        h = self.heads

        def split(z):
            return z.reshape(b, t, h, d // h).permute(0, 2, 1, 3)

        q = split(self.attention.self.query(x))
        k = split(self.attention.self.key(x))
        v = split(self.attention.self.value(x))
        att = (q @ k.transpose(-2, -1)) / math.sqrt(d // h)
        if bias is not None:
            att = att + bias
        att = att.softmax(-1)
        y = (att @ v).permute(0, 2, 1, 3).reshape(b, t, d)
        x = self.attention.output.LayerNorm(x + self.attention.output.dense(y))
        y = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + y)


class TorchBert(nn.Module):
    """HF-layout BERT encoder (embeddings and layers, no pooler)."""

    def __init__(self, vocab=128, dim=32, depth=2, heads=2, inter=64, max_pos=64):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(vocab, dim)
        self.embeddings.position_embeddings = nn.Embedding(max_pos, dim)
        self.embeddings.token_type_embeddings = nn.Embedding(2, dim)
        self.embeddings.LayerNorm = nn.LayerNorm(dim, eps=1e-12)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            [TorchBertLayer(dim, heads, inter) for _ in range(depth)]
        )

    def forward(self, input_ids, attention_mask=None):
        t = input_ids.shape[1]
        pos = torch.arange(t)[None, :]
        x = (
            self.embeddings.word_embeddings(input_ids)
            + self.embeddings.position_embeddings(pos)
            + self.embeddings.token_type_embeddings(torch.zeros_like(input_ids))
        )
        x = self.embeddings.LayerNorm(x)
        bias = None
        if attention_mask is not None:
            bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


class TorchBackboneWrapper(nn.Module):
    """HuggingFaceModel / ViTModel-style wrapper: the backbone sits at
    ``.model`` (reference ``huggingface_builder.py:6-17``), so state-dict
    keys gain the second ``.model.`` level of the reference layout."""

    def __init__(self, inner):
        super().__init__()
        self.model = inner

    def forward(self, *args, **kwargs):
        return self.model(*args, **kwargs)


class TorchTinyCLIP(nn.Module):
    """State-dict-compatible stand-in for the reference CLIPModel
    (``image_encoder.model.model.*``, ``text_encoder.model.model.*``,
    ``*_projection.linear``, ``loss.temperature``)."""

    def __init__(self, proj_dim=16, vit_kwargs=None, bert_kwargs=None):
        super().__init__()
        vit_kwargs = vit_kwargs or {}
        bert_kwargs = bert_kwargs or {}
        self.image_encoder = nn.Module()
        self.image_encoder.model = nn.Module()
        self.image_encoder.model.model = TorchViT(**vit_kwargs)
        self.text_encoder = nn.Module()
        self.text_encoder.model = TorchBackboneWrapper(TorchBert(**bert_kwargs))
        vdim = vit_kwargs.get("dim", 32)
        tdim = bert_kwargs.get("dim", 32)
        self.image_projection = nn.Module()
        self.image_projection.linear = nn.Linear(vdim, proj_dim, bias=False)
        self.text_projection = nn.Module()
        self.text_projection.linear = nn.Linear(tdim, proj_dim, bias=False)
        self.loss = nn.Module()
        self.loss.temperature = nn.Parameter(torch.tensor(0.03))


def torch_topk_pool(x, k, mask=None):
    """LoDA's top-k mean over tokens (padding masked out)."""
    if mask is not None:
        x = x.masked_fill((mask == 0).unsqueeze(-1), -10000.0)
        k = min(k, int(mask.sum(1).min()))
    vals = x.topk(k, dim=1)[0]
    return vals.mean(dim=1)


# --------------------------------------------------------------------------
# The reference eval at production settings
# --------------------------------------------------------------------------


def normalized_nchw(img_u8: np.ndarray) -> torch.Tensor:
    """ToTensor + Normalize of one (S, S, 3) uint8 image: (1, 3, S, S)."""
    x = (img_u8.astype(np.float32) / 255.0 - MEAN) / STD
    return torch.tensor(x.transpose(2, 0, 1))[None]


def torch_text_bank(tmodel, tok, class_bank_texts, max_length: int = 25):
    """The zero-shot classifier bank (reference
    ``tools/seg_evaluation.py:57-75``): per class, the L2-normed mean of the
    80 prompt embeddings."""
    bank = []
    with torch.no_grad():
        for cls in class_bank_texts:
            enc = tok(openai_imagenet_template(cls), padding="max_length",
                      truncation=True, max_length=max_length)
            ids = torch.tensor(enc["input_ids"])
            msk = torch.tensor(enc["attention_mask"])
            tokens = tmodel.text_encoder.model(ids, msk)
            emb = torch_topk_pool(tmodel.text_projection.linear(tokens), 1, msk)
            emb = F.normalize(emb, dim=-1).mean(0)
            bank.append((emb / emb.norm()).numpy())
    return np.stack(bank)


def torch_pooled_scores(tmodel, bank, img_u8, image_k: int = 5):
    """One image's global class scores (the inputs of the mean+std
    candidate threshold, reference :119-124)."""
    with torch.no_grad():
        tokens = tmodel.image_encoder.model.model(normalized_nchw(img_u8))[:, 1:]
        proj = tmodel.image_projection.linear(tokens)
        pooled = F.normalize(torch_topk_pool(proj, image_k), dim=-1)
    return bank @ pooled[0].numpy()


def candidate_decision(scores, num_classes: int, top_cls_num: int):
    """The reference's discrete candidate selection (:119-134) and its
    decision margin: the least |score - threshold| over every examined
    candidate slot. A scene whose margin is about 0 flips its whole
    candidate set under the least numeric jitter (bf16 against float32
    towers): such scenes measure coin flips, not pipeline quality."""
    top_k = min(top_cls_num, num_classes)
    order = np.argsort(-scores)[:top_k]
    top = scores[order]
    threshold = top.mean() + top.std(ddof=1)
    chosen = []
    margin = np.inf
    for idx in order[:5]:
        if idx in (0, 255):
            continue
        margin = min(margin, abs(float(scores[idx]) - float(threshold)))
        if scores[idx] < threshold:
            break
        chosen.append(int(idx))
    return chosen, float(margin)


def torch_production_eval(tmodel, tok, batches, class_bank_texts,
                          num_classes: int, top_cls_num: int,
                          max_length: int = 25, image_k: int = 5,
                          patch: int = 16, crf_kwargs=None):
    """The reference eval loop (reference ``tools/seg_evaluation.py:78-181``):
    float32 torch towers, numpy decode heuristics, the exact mean-field CRF,
    the 7x7 closing and the nearest resize to the GT size.

    batches: dicts of ``image`` (B, S, S, 3) uint8, ``mask_label`` (B, H, W)
    and ``mask_h`` / ``mask_w``. Returns (per-image predictions at the GT
    size, intersection totals, union totals, candidate sets).
    """
    crf_kwargs = crf_kwargs or {}
    bank = torch_text_bank(tmodel, tok, class_bank_texts, max_length)

    top_k = min(top_cls_num, num_classes)
    preds, cand_sets = [], []
    total_i = np.zeros(num_classes, np.float64)
    total_u = np.zeros(num_classes, np.float64)
    for batch in batches:
        for bi in range(batch["image"].shape[0]):
            img_u8 = np.asarray(batch["image"][bi])
            raw_h = int(batch["mask_h"][bi])
            raw_w = int(batch["mask_w"][bi])
            label = np.asarray(batch["mask_label"][bi])[:raw_h, :raw_w]
            grid = img_u8.shape[0] // patch

            with torch.no_grad():
                tokens = tmodel.image_encoder.model.model(
                    normalized_nchw(img_u8))[:, 1:]
                proj = tmodel.image_projection.linear(tokens)
                pooled = F.normalize(torch_topk_pool(proj, image_k), dim=-1)
                pooled = pooled[0].numpy()
                dense = F.normalize(proj, dim=-1)[0].numpy()

            # shortlist and threshold (:119-124; torch.std is ddof=1)
            scores = bank @ pooled
            order = np.argsort(-scores)[:top_k]
            top = scores[order]
            threshold = top.mean() + top.std(ddof=1)

            state = None
            chosen = []
            temp_pred = np.zeros((num_classes, raw_h, raw_w))
            for idx in order[:5]:
                if idx in (0, 255):
                    continue
                if scores[idx] < threshold:
                    break
                chosen.append(int(idx))
                attn = (dense @ bank[idx]).reshape(grid, grid)
                attn = attn.repeat(patch, 0).repeat(patch, 1)
                norm_attn = (attn - attn.min()) / (attn.max() - attn.min())
                if state is None:
                    state = crf_image_state(img_u8.astype(np.float64),
                                            **crf_kwargs)
                binary = exact_dense_crf_palette(
                    norm_attn, img_u8.astype(np.float64), _shared=state
                ) * 255
                m = closing(binary.astype(np.uint8))
                m = resize_nearest(m, raw_w, raw_h)
                temp_pred[idx] = m * scores[idx]

            pred = temp_pred.argmax(0)
            preds.append(pred)
            cand_sets.append(chosen)
            valid = label != 255
            for c in range(num_classes):
                pi = (pred == c) & valid
                li = (label == c) & valid
                inter = np.sum(pi & li)
                total_i[c] += inter
                total_u[c] += pi.sum() + li.sum() - inter
    return preds, total_i, total_u, cand_sets
