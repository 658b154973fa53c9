"""A sequencing run of one isolate: a genome of ``genome_bases`` uniform
ACGT codes, read as ``read_chars`` / ``read_length`` single reads of
``read_length`` bases from uniform positions, ``revcomp_fraction`` of
them from the reverse strand, each base replaced by another with
probability ``error_rate`` (the sequencer's substitutions). The genome
itself is not in the collection: each read is a record, in the order
drawn."""

from __future__ import annotations

import numpy as np

from benchmark import generator

ROLE = "collection"
PARAMS = {"genome_bases": None, "read_length": None, "read_chars": None,
          "error_rate": None, "revcomp_fraction": 0.5}


def make(g, p):
    G, rl = p["genome_bases"], p["read_length"]
    n = int(round(p["read_chars"] / rl))
    genome = g.integers(1, 5, G, dtype=np.uint8)
    start = g.integers(0, G - rl + 1, n)
    reads = np.lib.stride_tricks.sliding_window_view(genome, rl)[start]
    del genome, start
    flip = g.random(n) < p["revcomp_fraction"]
    reads[flip] = 5 - reads[flip, ::-1]
    bases = reads.reshape(-1)
    generator.substitute(g, bases, p["error_rate"])
    return bases, np.arange(n + 1, dtype=np.int64) * rl
