"""The one traffic generator: every input a cell hands the program is made
here from ``--seed`` and the parameters of a configuration's collection
(``configs/<config>.json``, key ``collection``) and of a traffic mix
(``traffic/<mix>.json``).

Each collection or mix names a ``kind``: a recipe in
``recipes/<kind>.py`` that declares its ``ROLE`` (``collection``,
``inputs`` or ``requests``) and its ``PARAMS`` with their defaults.
Parameters that a recipe does not declare are refused, so a file can
never ask for something that no code reads (a parameter declared as
None has to be given). Every mix also takes the
loop keys (``LOOP``) that the harness drives:

  loop        ``closed``: ``clients`` clients, each sending its next call
              when its last one is answered; ``open``: calls arrive as a
              Poisson process of ``rate_per_s``
  clients     closed loop only: calls outstanding at any time
  rate_per_s  open loop only

Random streams are numpy's, seeded by (seed, stream, index), so the same
seed gives the same inputs and every input can be made on its own.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

INVALID = 255                       # the program's separator code
LETTERS = np.frombuffer(b"$ACGT", np.uint8)
ALPHABETS = ("DNA",)                # what the references work out

# streams of one seed
STREAM_RECORDS = 1                  # the configuration's collection
STREAM_POOL = 2                     # the inputs of a code pool
STREAM_REQUESTS = 3                 # the timed requests
STREAM_WARM = 4                     # the warm-up requests
STREAM_CHECK = 5                    # the sample that is checked
STREAM_ARRIVALS = 6                 # an open loop's arrival times

LOOP = {"loop": "closed", "clients": 1, "rate_per_s": 0.0}
RECIPES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "recipes")


def rng(seed: int, *index: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *index])


def recipe(kind: str, role: str, where: str = RECIPES):
    """The recipe module of ``kind`` in the folder ``where``, which has
    to play ``role``."""
    path = os.path.join(where, kind + ".py")
    if not os.path.exists(path):
        raise ValueError(f"no recipe {kind!r} in {where}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_recipe_" + kind, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if module.ROLE != role:
        raise ValueError(f"recipe {kind!r} makes {module.ROLE}, not {role}")
    return module


def _params(kind: str, given: dict, declared: dict, what: str) -> dict:
    unknown = sorted(set(given) - set(declared) - {"kind"})
    if unknown:
        raise ValueError(f"{what} of kind {kind!r} does not take {unknown}")
    missing = sorted(k for k, v in declared.items()
                     if v is None and k not in given)
    if missing:
        raise ValueError(f"{what} of kind {kind!r} needs {missing}")
    return dict(declared, **given)


def mix(traffic: dict, role: str, where: str = RECIPES) -> dict:
    """A traffic mix with its recipe's and the loop's defaults filled in;
    a parameter that nothing reads, or a loop the harness cannot drive,
    is refused."""
    kind = traffic["kind"]
    declared = dict(recipe(kind, role, where).PARAMS)
    declared.update({k: v for k, v in LOOP.items() if k not in declared})
    out = _params(kind, traffic, declared, "traffic")
    if out["loop"] == "closed":
        if not (isinstance(out["clients"], int) and out["clients"] >= 1):
            raise ValueError(f"clients {out['clients']!r}: a whole number "
                             f"of at least 1")
        if out["rate_per_s"]:
            raise ValueError("a closed loop takes no rate_per_s")
    elif out["loop"] == "open":
        if not out["rate_per_s"] > 0:
            raise ValueError("an open loop needs rate_per_s > 0")
        if out["clients"] != 1:
            raise ValueError("an open loop takes no clients")
    else:
        raise ValueError(f"loop {out['loop']!r}: closed or open")
    return out


def arrivals(seed: int, traffic: dict, seconds: float) -> np.ndarray:
    """An open loop's arrival times in [0, seconds): a Poisson process of
    the mix's rate, from the seed."""
    rate = traffic["rate_per_s"]
    n = int(seconds * rate * 2) + 64
    t = np.cumsum(rng(seed, STREAM_ARRIVALS).exponential(1 / rate, n))
    return t[t < seconds]


def collection(seed: int, stream: int, index: int, config: dict,
               where: str = RECIPES):
    """(bases, bounds) of a configuration's collection: codes 1..4 of the
    records laid end to end, and the record bounds."""
    if config["alphabet"] not in ALPHABETS:
        raise ValueError(f"alphabet {config['alphabet']!r}: the references "
                         f"take {ALPHABETS}")
    c = config["collection"]
    r = recipe(c["kind"], "collection", where)
    params = _params(c["kind"], c, r.PARAMS, "collection")
    return r.make(rng(seed, stream, index), params)


def with_separators(bases: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """The records as one code array with INVALID after each."""
    return np.insert(bases, bounds[1:], INVALID)


def windows(bounds: np.ndarray, K: int) -> int:
    """k-mer windows inside the records."""
    return int(np.maximum(np.diff(bounds) - K + 1, 0).sum())


def substitute(g, codes: np.ndarray, rate: float) -> None:
    """Replace each code 1..4 of ``codes`` (flat, in place) by another one
    with probability ``rate``."""
    pos = bernoulli_positions(g, codes.size, rate)
    codes[pos] = (codes[pos] - 1 + g.integers(1, 4, pos.size,
                                              dtype=np.uint8)) % 4 + 1


def bernoulli_positions(g, n: int, p: float) -> np.ndarray:
    """The positions in [0, n) that independent draws of probability
    ``p`` select: sums of geometric gaps, without a draw per position."""
    if p <= 0:
        return np.zeros(0, np.int64)
    gaps = [np.zeros(0, np.int64)]
    total = 0
    while total < n:
        more = g.geometric(p, int(n * p * 1.2) + 64)
        gaps.append(more)
        total += int(more.sum())
    pos = np.cumsum(np.concatenate(gaps)) - 1
    return pos[pos < n]


def as_bytes(reads: np.ndarray) -> list:
    """Reads as the program takes them: one ACGT bytes object each."""
    flat = LETTERS[reads].tobytes()
    rl = reads.shape[1]
    return [flat[i:i + rl] for i in range(0, len(flat), rl)]
