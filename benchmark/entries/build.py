"""Index builds, back to back: ``build_boss_from_codes(codes, k,
alphabet, mode)`` from host codes to a finished BOSS table, closed by a
synchronize (what the CLI's ``build`` runs inside its ``construct``
span), over the traffic's pool of inputs (a recipe of role ``inputs``)
in the mix's order; the alphabet, k and mode are the configuration's.

Work: the k-mer windows of the input. Comparison with the plain
reference's table of the same codes: ``check_builds`` builds drawn from
the seed among the window's first ``check_within``, each by a positional
digest of W and last with the row count, F and the node count, taken on
the device right after the build (the only work of the benchmark inside
the window); and the window's last build array by array (W, last, F,
nodes).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generator
from benchmark.reference.boss import boss_table

ROLE = "inputs"
_CHUNK = 1 << 26
_HASH = 0x2545F491


class State:
    pass


def _inputs(cell, seed):
    r = generator.recipe(cell.traffic["kind"], ROLE, cell.recipes)
    return (r.inputs(seed, cell.config, cell.traffic, cell.recipes),
            r.order(seed, cell.traffic))


def _sample(cell, seed):
    w = cell.workload
    within = w.get("check_within", 8)
    return set(generator.rng(seed, generator.STREAM_CHECK).choice(
        within, min(w.get("check_builds", 2), within),
        replace=False).tolist())


def setup(cell, seed, device, log):
    from metagraph_tpu_torch.graph import boss_construct
    from metagraph_tpu_torch.kmer.alphabets import ALPHABETS
    s = State()
    s.cell, s.seed, s.device = cell, seed, device
    cfg = cell.config
    s.K, s.mode = cfg["k"], cfg["mode"]
    alphabet = ALPHABETS[cfg["alphabet"]]
    s.pool, s.order = _inputs(cell, seed)
    s.windows = [generator.windows(bounds, s.K) for _, _, bounds in s.pool]
    s.build = lambda codes: boss_construct.build_boss_from_codes(
        codes, s.K, alphabet, mode=s.mode, device=device)
    s.sample = _sample(cell, seed)
    s.digests, s.final = [], None
    for i in range(cell.traffic["warm_calls"]):       # the pool's shapes
        boss = call(s, i % len(s.pool))
        del boss
    log(f"set-up: {len(s.pool)} inputs of {len(s.pool[0][0])} codes, "
        f"{s.windows[0]} windows, k = {s.K} {s.mode}")
    return s


def items(s):
    return s.order


def call(s, item):
    boss = s.build(s.pool[item][0])
    if torch.device(s.device).type == "cuda":
        torch.cuda.synchronize()
    return boss


def work(s, item):
    return s.windows[item]


def digest(n, rows, F, nodes, device):
    """Device tensor (rows, positional hash of W, of last, F, nodes) of a
    table of ``n`` rows; ``rows(lo, hi)`` gives (W, last) of rows
    [lo, hi) on the device. int32 arithmetic over chunks."""
    h = torch.zeros(2, dtype=torch.int64, device=device)
    for lo in range(0, n, _CHUNK):
        hi = min(n, lo + _CHUNK)
        i = torch.arange(lo, hi, dtype=torch.int32, device=device)
        weight = ((i * _HASH) >> 8 & 0xFFFF) + 1
        W, last = rows(lo, hi)
        h[0] += ((W.to(torch.int32) + 1) * weight).sum(dtype=torch.int64)
        h[1] += (last.to(torch.int32) * weight).sum(dtype=torch.int64)
    return torch.cat([torch.tensor([n], device=device), h,
                      torch.as_tensor(F).to(device, torch.int64).reshape(-1),
                      torch.as_tensor(nodes).to(device,
                                                torch.int64).reshape(1)])


def _program_digest(boss):
    W, bits = boss.W, boss.last_rank

    def rows(lo, hi):
        return W[lo:hi], bits.bit(torch.arange(lo, hi, device=W.device))
    return digest(W.shape[0], rows, boss.F, boss.num_nodes(), W.device)


def keep(s, i, item, boss, ok, closing):
    if not ok:
        return
    if i in s.sample:
        s.digests.append((item, _program_digest(boss)))
    if closing:
        s.final = (item, boss)


def release(s):
    """The last build to the host, then every program object goes."""
    if s.final is not None:
        item, boss = s.final
        s.final = (item, {"W": boss.W.cpu().numpy(), "last": boss.last.numpy(),
                          "F": boss.F.cpu().numpy(),
                          "nodes": int(boss.num_nodes())})
        del boss
    s.digests = [(item, d.cpu().numpy()) for item, d in s.digests]
    s.build = None


def check(s, win, log):
    """Numbers compared, each with its limit: the reference is exact."""
    if not s.digests and s.final is None:
        return {"builds_checked_missing": {"value": 1, "limit": 0}}
    inputs = sorted({item for item, _ in s.digests}
                    | ({s.final[0]} if s.final else set()))
    differ = 0
    full = {"edges_gap": 0, "W_mismatch": 0, "last_mismatch": 0,
            "F_mismatch": 0, "nodes_gap": 0}
    for p in inputs:
        ref = boss_table(s.pool[p][0], s.K, s.mode, s.device)
        d = reference_digest(ref, s.device)
        differ += sum(int(not np.array_equal(got, d))
                      for item, got in s.digests if item == p)
        if s.final is not None and p == s.final[0]:
            full = compare_tables(s.final[1], ref)
        del ref
    log(f"compared {len(s.digests)} sampled builds by digest and the last "
        f"array by array ({len(inputs)} inputs) with the reference")
    out = {"builds_checked_missing": {
               "value": int(len(s.digests) < len(s.sample)
                            or s.final is None), "limit": 0},
           "builds_differing": {"value": differ, "limit": 0}}
    out.update({k: {"value": v, "limit": 0} for k, v in full.items()})
    return out


def reference_digest(ref, device):
    W = torch.from_numpy(ref["W"]).to(device)
    last = torch.from_numpy(ref["last"]).to(device)
    d = digest(W.shape[0], lambda lo, hi: (W[lo:hi], last[lo:hi]),
               torch.from_numpy(ref["F"]), ref["nodes"], device)
    return d.cpu().numpy()


def compare_tables(got, ref):
    n = min(len(got["W"]), len(ref["W"]))
    return {"edges_gap": abs(len(got["W"]) - len(ref["W"])),
            "W_mismatch": int((got["W"][:n].astype(np.int64)
                               != ref["W"][:n]).sum()),
            "last_mismatch": int((got["last"][:n] != ref["last"][:n]).sum()),
            "F_mismatch": int((np.asarray(got["F"], np.int64)
                               != ref["F"]).sum()),
            "nodes_gap": abs(got["nodes"] - ref["nodes"])}


def control(cell, seed, device, log):
    """The check's numbers for the control in the program's place: the
    reference with the dummy sources past the first level left out, for
    the sampled builds and a last one, of the seed's pool and order."""
    s = State()
    s.cell, s.seed, s.device = cell, seed, device
    s.K, s.mode = cell.config["k"], cell.config["mode"]
    s.pool, order = _inputs(cell, seed)
    s.sample = _sample(cell, seed)
    s.digests, s.final = [], None
    tables = {}
    for i in range(max(s.sample) + 1):
        item = next(order)
        if i in s.sample or i == max(s.sample):
            if item not in tables:
                tables[item] = boss_table(s.pool[item][0], s.K, s.mode,
                                          device, dummy_levels="first")
            if i in s.sample:
                s.digests.append((item, reference_digest(tables[item],
                                                         device)))
            s.final = (item, tables[item])
    return check(s, None, log)
