"""BERT-style caption corruption for contrastive pretraining (port of
``simseg_tpu/data/corruption.py``).

Parity: reference ``simseg/datasets/clip/utils.py:18-58``
(process_caption): in training each token is, with 20% probability,
corrupted (half of those become [MASK], a tenth a random vocab token, the
rest are deleted), and the word pieces are put back together into text.
The draws come from ``rng`` (default: the module-level ``random``) in the
same order as JAX's, so a seeded rng gives the same caption.
"""

from __future__ import annotations

import random
from typing import List


def _is_subtoken(word: str) -> bool:
    return word[:2] == "##"


def process_caption(tokenizer, caption: str, train: bool = True,
                    rng: random.Random = None) -> str:
    """The corrupted caption as text, over ``tokenizer.tokenize`` and
    ``tokenizer.vocab`` (the port's ``WordPieceTokenizer``)."""
    rng = rng or random
    tokens = tokenizer.tokenize(caption)
    vocab_keys = list(tokenizer.vocab.keys()) if hasattr(tokenizer, "vocab") else None

    output_tokens: List[str] = []
    deleted_idx: List[int] = []
    for token in tokens:
        prob = rng.random()
        if prob < 0.20 and train:
            prob /= 0.20
            if prob < 0.5:
                output_tokens.append("[MASK]")
            elif prob < 0.6 and vocab_keys:
                output_tokens.append(rng.choice(vocab_keys))
            else:
                output_tokens.append(token)
                deleted_idx.append(len(output_tokens) - 1)
        else:
            output_tokens.append(token)

    if deleted_idx:
        output_tokens = [
            t for i, t in enumerate(output_tokens) if i not in deleted_idx
        ]

    # word pieces back into words (reference :46-57, with its lookahead of
    # two continuations)
    restored: List[str] = []
    for i, tok in enumerate(output_tokens):
        if tok == "[MASK]":
            restored.append(tok)
            continue
        if (
            not _is_subtoken(tok)
            and i + 1 < len(output_tokens)
            and _is_subtoken(output_tokens[i + 1])
        ):
            restored.append(tok + output_tokens[i + 1][2:])
            if i + 2 < len(output_tokens) and _is_subtoken(output_tokens[i + 2]):
                restored[-1] = restored[-1] + output_tokens[i + 2][2:]
        elif not _is_subtoken(tok):
            restored.append(tok)
    return " ".join(restored)
