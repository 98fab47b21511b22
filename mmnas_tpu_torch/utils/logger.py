"""Append-only text log and EvalAI result-JSON writer (counterpart of
mmnas_tpu/utils/logger.py for one process): text logs at
`<LOG_ROOT>/log_<version>.txt` (train_vqa.py:328-338)."""

from __future__ import annotations

import datetime
import json
import os


class TextLogger:
    def __init__(self, log_root: str, version: str):
        self.path = os.path.join(log_root, f"log_{version}.txt")
        os.makedirs(log_root, exist_ok=True)

    def write(self, msg: str) -> None:
        with open(self.path, "a+") as f:
            f.write(msg.rstrip("\n") + "\n")

    def stamp(self) -> None:
        self.write("nowTime: " + datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"))


def dump_result_json(path: str, result) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f)
