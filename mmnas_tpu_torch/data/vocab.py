"""Tokenizer, vocabulary, and GloVe embedding cache.

The reference tokenizes by scanning every question/caption split and looks
each new word up in spaCy's en_vectors_web_lg GloVe table ONLINE at dataset
construction (load_data_vqa.py:142-172) — hundreds of MB of spaCy state per
worker. TPU rebuild: spaCy runs once OFFLINE (tools/make_glove_cache.py) to
produce <DATA_ROOT>/glove/<name>.vocab.json + .npy; training hosts just
memory-map the .npy. Without a cache (or spaCy), embeddings fall back to
deterministic random vectors so the pipeline still runs (synthetic/dev).

Tokenization regex parity: lowercase, strip [.,'!?"()*#:;], '-'/'/' -> ' ',
whitespace split (load_data_vqa.py:159-163).

The port's own copy of mmnas_tpu/data/vocab.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Dict, Iterable, List, Tuple

import numpy as np

SPECIAL_TOKENS = ("PAD", "UNK", "CLS")
_CLEAN_RE = re.compile(r"([.,'!?\"()*#:;])")


def tokenize_question(text: str) -> List[str]:
    return (_CLEAN_RE.sub("", text.lower())
            .replace("-", " ").replace("/", " ").split())


def _random_emb(token_to_ix: Dict[str, int], dim: int) -> np.ndarray:
    g = np.random.RandomState(1234)
    emb = g.randn(len(token_to_ix), dim).astype(np.float32) * 0.1
    emb[token_to_ix["PAD"]] = 0.0
    return emb


def load_glove_cache(cache_dir: str, name: str):
    """Returns (token_to_vec_index dict, emb matrix) or None."""
    vocab_p = os.path.join(cache_dir, f"{name}.vocab.json")
    emb_p = os.path.join(cache_dir, f"{name}.npy")
    if os.path.exists(vocab_p) and os.path.exists(emb_p):
        with open(vocab_p) as f:
            vocab = json.load(f)
        return vocab, np.load(emb_p, mmap_mode="r")
    return None


def build_vocab_from_token_lists(token_lists: Iterable[List[str]], cfg,
                                 cache_name: str = "vgd"
                                 ) -> Tuple[Dict[str, int], np.ndarray]:
    """Vocab in first-seen order with PAD/UNK/CLS prefix
    (load_data_vgd.py:110-131)."""
    token_to_ix = {t: i for i, t in enumerate(SPECIAL_TOKENS)}
    for tokens in token_lists:
        for w in tokens:
            if w not in token_to_ix:
                token_to_ix[w] = len(token_to_ix)
    emb = _lookup_glove(token_to_ix, cfg, cache_name)
    return token_to_ix, emb


def build_vocab_from_questions(questions: Iterable[str], cfg,
                               cache_name: str = "vqa"
                               ) -> Tuple[Dict[str, int], np.ndarray]:
    """Vocab from raw question strings (load_data_vqa.py:142-172)."""
    return build_vocab_from_token_lists(
        (tokenize_question(q) for q in questions), cfg, cache_name)


def _lookup_glove(token_to_ix: Dict[str, int], cfg, cache_name: str) -> np.ndarray:
    dim = cfg.WORD_EMBED_SIZE
    if not cfg.GLOVE_FEATURE:
        return _random_emb(token_to_ix, dim)
    cache = load_glove_cache(os.path.join(cfg.DATA_ROOT, "glove"), cache_name)
    if cache is None:
        # try live spaCy as a last resort (matches the reference exactly)
        try:  # pragma: no cover - spaCy not in the image
            import en_vectors_web_lg
            tool = en_vectors_web_lg.load()
            emb = np.stack([tool(w).vector for w in token_to_ix])
            return emb.astype(np.float32)
        except Exception:
            warnings.warn(
                "no GloVe cache at <DATA_ROOT>/glove and spaCy unavailable; "
                "using deterministic random embeddings "
                "(run tools/make_glove_cache.py offline for real GloVe)")
            return _random_emb(token_to_ix, dim)
    vocab, table = cache
    emb = np.zeros((len(token_to_ix), dim), np.float32)
    for w, i in token_to_ix.items():
        j = vocab.get(w, vocab.get("UNK"))
        if j is not None:
            emb[i] = table[j]
    return emb
