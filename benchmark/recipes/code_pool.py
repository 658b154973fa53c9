"""Inputs of a build: a pool of ``pool`` distinct collections of the
configuration, each drawn from the seed's pool stream and handed to the
program as one code array (INVALID after each record, as its FASTA reader
returns the records), called in turn (0, 1, ..., pool - 1, 0, ...) after
``warm_calls`` calls of warm-up."""

from __future__ import annotations

import itertools

from benchmark import generator

ROLE = "inputs"
PARAMS = {"pool": None, "warm_calls": 2}


def inputs(seed: int, config: dict, mix: dict, where: str):
    """[(codes, bases, bounds)] of the pool; ``where`` holds the
    collection's recipe."""
    out = []
    for i in range(mix["pool"]):
        bases, bounds = generator.collection(seed, generator.STREAM_POOL, i,
                                             config, where)
        out.append((generator.with_separators(bases, bounds), bases, bounds))
    return out


def order(seed: int, mix: dict):
    """The pool indices of the calls, without end."""
    return (i % mix["pool"] for i in itertools.count())
