"""A genome collection of species clusters: ``species`` ancestral genomes
of ``record_bases`` uniform ACGT codes, each indexed as
``strains_per_species`` strains that differ from their ancestor by
independent substitutions at ``strain_divergence`` per base (two strains
of one species at about twice that), the ancestors themselves not in the
collection. Records lie species by species, strain by strain, each
``record_bases`` long."""

from __future__ import annotations

import numpy as np

from benchmark import generator

ROLE = "collection"
PARAMS = {"species": None, "strains_per_species": None,
          "record_bases": None, "strain_divergence": None}


def make(g, p):
    S, n, L = p["species"], p["strains_per_species"], p["record_bases"]
    ancestors = g.integers(1, 5, (S, L), dtype=np.uint8)
    bases = np.repeat(ancestors, n, axis=0).reshape(-1)
    del ancestors
    generator.substitute(g, bases, p["strain_divergence"])
    bounds = np.arange(S * n + 1, dtype=np.int64) * L
    return bases, bounds
