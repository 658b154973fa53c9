"""Requests of reads against the configuration's collection: each holds
``reads_per_request`` reads of ``read_length`` bases; an
``indexed_fraction`` of them cut from random positions of random records
of the collection, ``revcomp_fraction`` of those reverse-complemented,
each base of them replaced by another with probability ``error_rate``
(the sequencer's substitutions); the rest uniform random (organisms
outside the index); in an order drawn from the seed. ``pool_requests``
are made in set-up, ``warm_requests`` more warm up. ``source`` names
where the numbers come from."""

from __future__ import annotations

import numpy as np

from benchmark import generator

ROLE = "requests"
PARAMS = {"reads_per_request": None, "read_length": None,
          "indexed_fraction": None, "revcomp_fraction": 0.5,
          "error_rate": None, "pool_requests": None, "warm_requests": 2,
          "source": ""}


def request(seed: int, stream: int, index: int, bases: np.ndarray,
            bounds: np.ndarray, mix: dict) -> np.ndarray:
    """One request's reads as (reads, read_length) codes 1..4."""
    g = generator.rng(seed, stream, index)
    n = mix["reads_per_request"]
    rl = mix["read_length"]
    n_map = int(round(n * mix["indexed_fraction"]))
    rec = g.integers(0, len(bounds) - 1, n_map)
    span = bounds[rec + 1] - bounds[rec] - rl + 1
    start = bounds[rec] + (g.random(n_map) * span).astype(np.int64)
    mapped = bases[start[:, None] + np.arange(rl)]
    n_rc = int(round(n_map * mix["revcomp_fraction"]))
    flip = g.permutation(n_map)[:n_rc]
    mapped[flip] = 5 - mapped[flip, ::-1]
    generator.substitute(g, mapped.reshape(-1), mix["error_rate"])
    random = g.integers(1, 5, (n - n_map, rl), dtype=np.uint8)
    reads = np.concatenate([mapped, random])
    return reads[g.permutation(n)]
