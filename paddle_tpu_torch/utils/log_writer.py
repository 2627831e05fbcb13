"""LogWriter: scalar, histogram and text logging for experiments
(counterpart of ``paddle_tpu/utils/log_writer.py``; the role of the
VisualDL ``LogWriter`` that Paddle's hapi ``VisualDL`` callback wraps).

Format: JSON lines, one event a line, one file per writer."""
from __future__ import annotations

import json
import os
import time

import numpy as np

__all__ = ["LogWriter"]


class LogWriter:
    _seq = 0

    def __init__(self, logdir="vdl_log", file_name=None, display_name=None,
                 **kwargs):
        os.makedirs(logdir, exist_ok=True)
        LogWriter._seq += 1  # pid and sequence: no clash within a second
        name = file_name or (
            f"vdlrecords.{int(time.time())}.{os.getpid()}"
            f".{LogWriter._seq}.jsonl")
        self.logdir = logdir
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "a")

    def _write(self, kind, tag, step, payload):
        rec = {"kind": kind, "tag": tag, "step": int(step),
               "wall_time": time.time(), **payload}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def add_scalar(self, tag, value, step=0, walltime=None):
        self._write("scalar", tag, step, {"value": float(value)})

    def add_histogram(self, tag, values, step=0, buckets=10):
        hist, edges = np.histogram(np.asarray(values).ravel(), bins=buckets)
        self._write("histogram", tag, step,
                    {"hist": hist.tolist(), "edges": edges.tolist()})

    def add_text(self, tag, text_string, step=0):
        self._write("text", tag, step, {"text": str(text_string)})

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
