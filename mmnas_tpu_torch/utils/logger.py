"""Append-only text log and EvalAI result-JSON writer (counterpart of
mmnas_tpu/utils/logger.py): text logs at `<LOG_ROOT>/log_<version>.txt`
(train_vqa.py:328-338). Rank 0 of a data-parallel group is the only
writer (parallel/mesh.py)."""

from __future__ import annotations

import datetime
import json
import os

from mmnas_tpu_torch.parallel.mesh import is_writer


class TextLogger:
    def __init__(self, log_root: str, version: str):
        self.path = os.path.join(log_root, f"log_{version}.txt")
        if is_writer():
            os.makedirs(log_root, exist_ok=True)

    def write(self, msg: str) -> None:
        if not is_writer():
            return
        with open(self.path, "a+") as f:
            f.write(msg.rstrip("\n") + "\n")

    def stamp(self) -> None:
        self.write("nowTime: " + datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"))


def dump_result_json(path: str, result) -> None:
    if not is_writer():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f)
