"""Offline GloVe embedding cache builder: the port's own copy of
tools/make_glove_cache.py (the port imports nothing of the JAX package).

The reference looks every vocabulary word up in spaCy's en_vectors_web_lg
ONLINE during dataset construction (load_data_vqa.py:142-172). This script
runs once, scans the same question/caption/token sources and writes

    <DATA_ROOT>/glove/<name>.vocab.json   {word: row}
    <DATA_ROOT>/glove/<name>.npy          [V, 300] float32

which mmnas_tpu_torch.data.vocab memory-maps at train time. With --stub it
needs no spaCy: deterministic per-word pseudo-vectors, the same files bit for
bit as the JAX package's tool writes (tests/test_torch_rehearsal.py).

Usage:
    python -m mmnas_tpu_torch.tools.make_glove_cache --task vqa --data_root ./data --stub
    python -m mmnas_tpu_torch.tools.make_glove_cache --task vgd --data_root ./data --dataset refcoco
    python -m mmnas_tpu_torch.tools.make_glove_cache --task itm --data_root ./data
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def iter_words(task: str, data_root: str, dataset: str):
    from mmnas_tpu_torch.data import paths as P
    from mmnas_tpu_torch.data.vocab import tokenize_question
    if task == "vqa":
        qp = P.VqaPaths(data_root).question_paths()
        for key in ("train", "val", "test", "vg"):
            with open(qp[key]) as f:
                for q in json.load(f)["questions"]:
                    yield from tokenize_question(q["question"])
    elif task == "vgd":
        vp = P.VgdPaths(data_root, dataset, "vg_woref")
        for p in vp.ref_jsons().values():
            if os.path.exists(p):
                with open(p) as f:
                    for r in json.load(f):
                        yield from r["tokens"]
    else:  # itm
        ip = P.ItmPaths(data_root, dataset if dataset != "refcoco" else "flickr")
        for k, p in ip.caption_paths().items():
            if "caps" in k and os.path.exists(p):
                with open(p) as f:
                    for line in f:
                        yield from tokenize_question(line.strip())


class _StubTool:
    """Deterministic per-word pseudo-vectors (hash-seeded, 300-d): stands in
    for spaCy when no network/model is available (rehearsals, CI). Real
    accuracy runs must use the spaCy table — the stub only exercises the
    cache-producing and cache-consuming code paths with stable vectors."""

    class _Vec:
        def __init__(self, w):
            import zlib
            g = np.random.RandomState(zlib.crc32(w.encode()) & 0x7FFFFFFF)
            self.vector = (g.randn(300) * 0.1).astype(np.float32)

    def __call__(self, w):
        return self._Vec(w)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--task", required=True, choices=["vqa", "vgd", "itm"])
    p.add_argument("--data_root", default="./data")
    p.add_argument("--dataset", default="refcoco")
    p.add_argument("--stub", action="store_true",
                   help="deterministic pseudo-vectors instead of spaCy")
    args = p.parse_args()

    if args.stub:
        tool = _StubTool()
    else:
        try:
            import en_vectors_web_lg
            tool = en_vectors_web_lg.load()
        except ImportError:
            raise SystemExit(
                "spaCy en_vectors_web_lg is required for this OFFLINE step "
                "(pip install spacy && download en_vectors_web_lg); training "
                "hosts only need the produced cache files. For a no-network "
                "rehearsal use --stub.")

    vocab = {"PAD": 0, "UNK": 1, "CLS": 2}
    vecs = [tool("PAD").vector, tool("UNK").vector, tool("CLS").vector]
    for w in iter_words(args.task, args.data_root, args.dataset):
        if w not in vocab:
            vocab[w] = len(vocab)
            vecs.append(tool(w).vector)

    out_dir = os.path.join(args.data_root, "glove")
    os.makedirs(out_dir, exist_ok=True)
    name = args.task
    with open(os.path.join(out_dir, f"{name}.vocab.json"), "w") as f:
        json.dump(vocab, f)
    np.save(os.path.join(out_dir, f"{name}.npy"),
            np.asarray(vecs, np.float32))
    print(f"wrote {len(vocab)} vectors to {out_dir}/{name}.*")


if __name__ == "__main__":
    main()
