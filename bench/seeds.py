"""Seeds derived from the run's ``--seed``: every random draw of a run
(weights, each step's batch) takes its own, so the same seed gives the
same inputs and two draws never share a stream."""

import hashlib


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for the draw named by ``parts`` under ``seed``."""
    h = hashlib.blake2b(repr((int(seed),) + parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1
