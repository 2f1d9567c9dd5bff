"""Self-contained WordPiece tokenizer (port of
``simseg_tpu/data/tokenizer.py:28-164``).

Parity: the reference tokenizes with ``AutoTokenizer.from_pretrained(tag)``
padded/truncated to ``model.max_length`` (= 25). This is standard BERT
basic + WordPiece tokenization (lowercase, punctuation split, greedy
longest-match with ## continuations) over a local ``vocab.txt``.
``build_tokenizer`` (JAX :167-185) takes a HuggingFace tokenizer first where
one resolves without the network (a local directory, else the tag in the HF
cache, ``local_files_only``), else this WordPiece over ``vocab_file``; the
entry points and ``build_clip_dataloaders`` build theirs through it, as
JAX's do.
"""

from __future__ import annotations

import logging
import os
import unicodedata
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    """BERT-uncased-style tokenizer over a vocab.txt."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_chars_per_word: int = 100) -> None:
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.cls_token, self.sep_token = "[CLS]", "[SEP]"
        self.pad_token, self.unk_token, self.mask_token = "[PAD]", "[UNK]", "[MASK]"
        for t in (self.cls_token, self.sep_token, self.pad_token, self.unk_token):
            if t not in vocab:
                raise ValueError(f"vocab missing special token {t}")

    @classmethod
    def from_vocab_file(cls, path: str) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        logger.info("WordPiece tokenizer from %s (%d tokens)", path, len(vocab))
        return cls(vocab)

    # -- basic tokenization ---------------------------------------------------
    def _basic_tokenize(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out: List[str] = []
        word: List[str] = []
        for ch in text:
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif _is_punctuation(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    # -- wordpiece -------------------------------------------------------------
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            tokens.append(piece)
            start = end
        return tokens

    def tokenize(self, text: str) -> List[str]:
        # special tokens pass through verbatim (corruption re-inserts [MASK]
        # into the surface text) — split them out before basic tokenization,
        # matching HF's never_split behavior.
        specials = (self.mask_token, self.cls_token, self.sep_token,
                    self.pad_token, self.unk_token)
        segments = [text]
        for sp in specials:
            next_segments: List[str] = []
            for seg in segments:
                if seg in specials:
                    next_segments.append(seg)
                    continue
                parts = seg.split(sp)
                for i, part in enumerate(parts):
                    if part:
                        next_segments.append(part)
                    if i < len(parts) - 1:
                        next_segments.append(sp)
            segments = next_segments

        out: List[str] = []
        for seg in segments:
            if seg in specials:
                out.append(seg)
                continue
            for word in self._basic_tokenize(seg):
                out.extend(self._wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def __call__(self, texts, padding: str = "max_length", truncation: bool = True,
                 max_length: int = 25) -> Dict[str, List[List[int]]]:
        if isinstance(texts, str):
            texts = [texts]
        input_ids, attention_mask = [], []
        for text in texts:
            toks = self.tokenize(text)
            if truncation:
                toks = toks[: max_length - 2]
            ids = (
                [self.vocab[self.cls_token]]
                + self.convert_tokens_to_ids(toks)
                + [self.vocab[self.sep_token]]
            )
            mask = [1] * len(ids)
            if padding == "max_length":
                pad = max_length - len(ids)
                ids = ids + [self.vocab[self.pad_token]] * pad
                mask = mask + [0] * pad
            input_ids.append(ids)
            attention_mask.append(mask)
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def make_test_vocab(extra_words: Sequence[str] = ()) -> Dict[str, int]:
    """Small deterministic vocab for tests: specials + ascii chars +
    ##-continuations + provided words."""
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    tokens += letters + ["##" + c for c in letters]
    tokens += [str(d) for d in range(10)]
    tokens += [w for w in dict.fromkeys(extra_words) if w not in set(tokens)]
    return {t: i for i, t in enumerate(tokens)}


def _hf_local(src: str) -> bool:
    """Whether ``src`` can resolve offline: a directory, or a repo in the
    HF hub cache. Where neither holds, ``from_pretrained(...,
    local_files_only=True)`` fails, so ``transformers`` (seconds to import)
    is not imported for it."""
    if os.path.isdir(src):
        return True
    try:
        from huggingface_hub import constants
    except ImportError:
        return False
    return os.path.isdir(os.path.join(constants.HF_HUB_CACHE,
                                      "models--" + src.replace("/", "--")))


def build_tokenizer(tag: str, vocab_file: Optional[str] = None,
                    local_dir: Optional[str] = None):
    """A HuggingFace tokenizer if one resolves locally, else WordPiece over
    ``vocab_file``, in JAX's order: ``local_dir``, the HF cache (offline:
    ``local_files_only``, never a download), ``vocab_file``. Without
    ``transformers``, or when neither resolves, the WordPiece path; neither
    that: RuntimeError."""
    src = local_dir or tag
    try:
        if _hf_local(src):
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(src, local_files_only=True)
    except Exception:
        pass
    if vocab_file and os.path.exists(vocab_file):
        logger.info(f"Using bundled WordPiece tokenizer from {vocab_file}")
        return WordPieceTokenizer.from_vocab_file(vocab_file)
    raise RuntimeError(
        f"Cannot build tokenizer for '{tag}': no local HF cache and no "
        f"vocab_file. Download the tokenizer or pass data.vocab_file.")

