"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card skipped, a whole run driven on the CPU,
once for each fault that a cell can have (one card: no exchange between
chips to leave out)."""

import pytest

from benchmark.tests._tiny import CELLS, run


def test_sound_runs_are_correct():
    for cell in CELLS:
        r = run(cell)
        assert r["correct"], (cell, r["attempted"], r["checks"])


def _break_build(monkeypatch, fault):
    from metagraph_tpu_torch.graph import boss_construct
    orig = boss_construct.build_boss_from_codes
    last = []

    def broken(codes, *a, **k):
        if fault == "half":                  # half the records left out
            half = codes[:len(codes) // 2]
            return orig(half, *a, **k)
        boss = orig(codes, *a, **k)
        if fault == "stale":                 # the state returned unchanged
            last.append(boss)
            return last[0]
        if fault == "altered":               # one W symbol altered
            words = boss.W_rank.seq_words
            words[len(words) // 4] ^= 1
        if fault == "last_altered":          # one last bit altered
            words = boss.last_rank.words
            words[len(words) // 3] ^= 1 << 7
        return boss

    monkeypatch.setattr(boss_construct, "build_boss_from_codes", broken)


def _break_query(monkeypatch, fault):
    from metagraph_tpu_torch.engine.annotated_dbg import BatchQuery
    orig = BatchQuery.get_labels_batch
    first = []

    def broken(self, seqs, ratio=0.0):
        if fault == "half":                  # half the reads left out
            out = orig(self, seqs[:len(seqs) // 2], ratio)
            return out + [[] for _ in seqs[len(seqs) // 2:]]
        out = orig(self, seqs, ratio)
        if fault == "stale":                 # the first answer returned
            first.append(out)
            return first[0]
        if fault == "altered":               # one label altered
            r = next(i for i, x in enumerate(out) if x)
            out[r] = ["rec_0" if out[r][0] != "rec_0" else "rec_1"]
        return out

    monkeypatch.setattr(BatchQuery, "get_labels_batch", broken)


@pytest.mark.parametrize("fault", ["stale", "half", "altered",
                                   "last_altered"])
def test_broken_build_is_not_correct(monkeypatch, fault):
    _break_build(monkeypatch, fault)
    r = run("build.dna31-primary")
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_broken_query_is_not_correct(monkeypatch, fault):
    _break_query(monkeypatch, fault)
    r = run("query.dna31-canonical-rdbrwt")
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_a_failed_call_is_not_correct(monkeypatch):
    from metagraph_tpu_torch.graph import boss_construct
    orig = boss_construct.build_boss_from_codes
    calls = []

    def fails(*a, **k):                     # the warm-up build passes
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("out of memory")
        return orig(*a, **k)
    monkeypatch.setattr(boss_construct, "build_boss_from_codes", fails)
    r = run("build.dna31-primary")
    assert not r["correct"] and r["failed"] == r["attempted"] > 0
