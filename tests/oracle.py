"""Tiny pure-Python k-mer oracle used by unit tests (independent of both the
reference implementation and the device engine)."""

from collections import Counter


def naive_kmers(records: list[str], k: int, min_count: int = 1) -> dict[str, int]:
    c: Counter = Counter()
    for seq in records:
        seq = seq.replace("*", "")
        for i in range(len(seq) - k + 1):
            c[seq[i : i + k]] += 1
    return {km: n for km, n in c.items() if n >= min_count}
