"""Tiny cells for the CPU tests: a benchmark cell cut to 2 SMs and a few
hundred threads, so that the plain versions of the family kernels
(engine ``torch``) run it in seconds."""

from __future__ import annotations

import copy

from warpbench import spec

THREADS = {"BFS": 512, "MP": 256, "BKP": 512}


def cell(name: str) -> spec.Cell:
    c = spec.find_cell(name)
    c.config = copy.deepcopy(c.config)
    c.config["machine"]["num_sms"] = 2
    c.config["threads"] = dict(THREADS)
    return c
