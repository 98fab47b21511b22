"""Genotype (searched-architecture) JSON IO.

Schema is pinned to the reference (arch/*.json; search_vqa.py:382-386):

    {"epoch<K>": {"enc": [["op"], ...x12], "dec": [["op"], ...x18]}}

Each node is a *list* of op names (Cell_Full sums all ops of a node,
full_vqa.py:24-28); searched genotypes always emit singleton nodes.

The port's own copy of mmnas_tpu/genotype.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

Genotype = Dict[str, List[List[str]]]  # {"enc": [[op],...], "dec": [[op],...]}


def load_genotype(path: str, epoch: int = 0) -> Genotype:
    """Reference load: json[f'epoch{GENO_EPOCH}'] (train_vqa.py:185)."""
    with open(path) as f:
        archive = json.load(f)
    key = f"epoch{epoch}"
    if key not in archive:
        raise KeyError(
            f"{path} has no '{key}' (available: {sorted(archive)})")
    return archive[key]


def append_genotype(path: str, epoch: int, genotype: Genotype) -> None:
    """Per-epoch append used during search (search_vqa.py:382-386)."""
    archive = {}
    if os.path.exists(path):
        with open(path) as f:
            archive = json.load(f)
    archive[f"epoch{epoch}"] = genotype
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(archive, f)


def validate_genotype(genotype: Genotype, known_ops) -> None:
    for cell_type in ("enc", "dec"):
        if cell_type not in genotype:
            raise ValueError(f"genotype missing '{cell_type}' cell")
        for node in genotype[cell_type]:
            if not isinstance(node, list) or not node:
                raise ValueError(f"genotype node must be a non-empty list: {node!r}")
            for op_name in node:
                if op_name not in known_ops:
                    raise ValueError(f"unknown op '{op_name}' in genotype")
