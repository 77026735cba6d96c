"""Run logger: the primary rank's text log, JSONL metrics and config snapshot.

Port of ``text_to_sound_synthesis_tpu/engine/logger.py`` (reference
``Logger``, ``Diffsound/sound_synthesis/engine/logger.py:22-93``): the run
directory layout (``<output>/<name>/{checkpoint, configs}``), the merged
config, an appended text log, and scalar metrics as JSONL (and to
TensorBoard when ``tensorboard`` is installed).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Mapping, Optional

from ..parallel.distributed import is_primary as _is_primary
from ..utils.config import save_config_to_yaml

__all__ = ["Logger"]


class Logger:
    def __init__(self, output_dir: str, name: str = "run", is_primary: Optional[bool] = None):
        self.is_primary = _is_primary() if is_primary is None else is_primary
        self.run_dir = os.path.join(output_dir, name)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoint")
        self.config_dir = os.path.join(self.run_dir, "configs")
        self._text = self._jsonl = self._tb = None
        if self.is_primary:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            os.makedirs(self.config_dir, exist_ok=True)
            self._text = open(os.path.join(self.run_dir, "log.txt"), "a")
            self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:       # tensorboard is optional
                pass
            else:
                self._tb = SummaryWriter(log_dir=os.path.join(self.run_dir, "tb"))

    def save_config(self, config: Mapping[str, Any], name: str = "config.yaml") -> None:
        if self.is_primary:
            save_config_to_yaml(dict(config), os.path.join(self.config_dir, name))

    def log_info(self, msg: str, check_primary: bool = True) -> None:
        if self.is_primary or not check_primary:
            line = f"{time.strftime('%Y-%m-%d %H:%M:%S')}: {msg}"
            print(line, file=sys.stderr)
            if self._text:
                self._text.write(line + "\n")
                self._text.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                          "step": int(step)}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        for f in (self._text, self._jsonl):
            if f:
                f.close()
        if self._tb is not None:
            self._tb.close()
