"""Wireless-network delay model (paper §5.1), the benchmark's frozen copy
of ``repro_torch/fl/network.py``: the traffic's client delays.  The
harness hands this object to the program as its network; later changes
to the program's copy do not change a cell's arrivals.

Clients are split into M resource groups; client c in group g has a
per-round training delay ~ N(mean_g, std).  With probability mu the round
suffers a transmission/compute failure adding U(30, 60) seconds.  All
draws are deterministic functions of (seed, client, round, attempt) so
every FL method sees the *identical* network realization — the paper's
comparisons assume this.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Vectorized PCG64 seeding
#
# ``delay`` keys an independent PCG64 stream off every (seed, client,
# round, attempt) tuple, so a cohort of C clients pays C full
# ``default_rng`` constructions — SeedSequence entropy hashing dominates
# and is a host-side hot spot in long simulations.  The hash itself
# (numpy's SeedSequence pool mix + generate_state, frozen by numpy's
# stream-compatibility guarantee) is plain uint32 arithmetic, so we run
# it across the whole cohort as numpy array ops and then seat each
# resulting (state, inc) pair into ONE reused PCG64 via its documented
# ``.state`` setter.  Bit-for-bit equality with ``default_rng(seed)`` is
# checked by flbench/tests/test_flbench_frozen.py against the program.
# ---------------------------------------------------------------------------

_INIT_A = 0x43b0d7e5
_MULT_A = 0x931e8875
_INIT_B = 0x8b51f9dd
_MULT_B = 0x58f38ded
_MIX_L = 0xca01f9dd
_MIX_R = 0x4973f715
_PCG_MULT = (0x2360ed051fc65da4 << 64) + 0x4385df649fccf645
_M128 = (1 << 128) - 1


def _pcg64_states(seeds: np.ndarray) -> List[Tuple[int, int]]:
    """SeedSequence(seed) -> seeded PCG64 (state, inc) for a whole batch.

    Reproduces numpy's entropy pool mix and generate_state word-for-word
    (seeds < 2**64; low/high uint32 words — a high word of 0 hashes
    identically to the 1-word entropy path), then applies PCG64's
    srandom step in 128-bit Python ints.
    """
    u32 = np.uint32
    e0 = (seeds & 0xffffffff).astype(u32)
    e1 = ((seeds >> np.uint64(32)) & 0xffffffff).astype(u32)
    hc = _INIT_A

    def _hash(val, hc, mult):
        val = val ^ u32(hc)
        hc = (hc * mult) & 0xffffffff
        val = val * u32(hc)
        val ^= val >> u32(16)
        return val, hc

    pool = [None] * 4
    pool[0], hc = _hash(e0, hc, _MULT_A)
    pool[1], hc = _hash(e1, hc, _MULT_A)
    zero = np.zeros_like(e0)
    pool[2], hc = _hash(zero, hc, _MULT_A)
    pool[3], hc = _hash(zero, hc, _MULT_A)
    for i_src in range(4):
        for i_dst in range(4):
            if i_src != i_dst:
                h, hc = _hash(pool[i_src], hc, _MULT_A)
                r = pool[i_dst] * u32(_MIX_L) - h * u32(_MIX_R)
                pool[i_dst] = r ^ (r >> u32(16))
    hc = _INIT_B
    words = []
    for i in range(8):
        d, hc = _hash(pool[i % 4], hc, _MULT_B)
        words.append(d.astype(np.uint64))
    w64 = [words[2 * k] | (words[2 * k + 1] << np.uint64(32))
           for k in range(4)]
    hi_s, lo_s, hi_i, lo_i = (w.tolist() for w in w64)
    out = []
    for k in range(len(hi_s)):
        initstate = (hi_s[k] << 64) | lo_s[k]
        inc = ((((hi_i[k] << 64) | lo_i[k]) << 1) | 1) & _M128
        st = ((inc + initstate) * _PCG_MULT + inc) & _M128
        out.append((st, inc))
    return out


class WirelessNetwork:
    def __init__(self, n_clients: int, tier_delay_means: Sequence[float],
                 delay_std: float = 2.0, mu: float = 0.0,
                 failure_delay: Tuple[float, float] = (30.0, 60.0),
                 seed: int = 0):
        self.n_clients = n_clients
        self.mu = float(mu)
        self.failure_delay = failure_delay
        self.delay_std = float(delay_std)
        self.seed = int(seed)
        g = len(tier_delay_means)
        # paper: "divide all clients into M parts" — contiguous groups
        self.group = np.repeat(np.arange(g), -(-n_clients // g))[:n_clients]
        self.means = np.asarray(tier_delay_means, np.float64)[self.group]

    def _rng(self, client: int, rnd: int, attempt: int = 0):
        return np.random.default_rng(
            (self.seed * 1_000_003 + client * 9_176 + rnd * 131 + attempt)
            % (2 ** 63))

    def delay(self, client: int, rnd: int, attempt: int = 0) -> float:
        """Sampled wall-clock cost of one local round for ``client``."""
        rng = self._rng(client, rnd, attempt)
        base = max(0.1, rng.normal(self.means[client], self.delay_std))
        if rng.random() < self.mu:
            lo, hi = self.failure_delay
            base += rng.uniform(lo, hi)
        return float(base)

    def delays(self, clients, rnd, attempt=0) -> np.ndarray:
        """Sample a whole cohort in one call, bit-for-bit identical to
        ``[delay(c, r, a) for ...]``.

        ``rnd`` and ``attempt`` may be scalars or per-client arrays
        (broadcast against ``clients``).  The per-stream SeedSequence
        entropy hash runs once for the whole cohort as vectorized
        uint32 numpy ops (see ``_pcg64_states``); each element then
        costs only a PCG64 ``.state`` seat + the draws themselves,
        instead of a full ``default_rng`` construction.  The failure
        draw is skipped when ``mu == 0`` (nothing is sampled after it,
        so skipping cannot shift any stream).
        """
        cl = np.atleast_1d(np.asarray(clients, np.int64))
        n = cl.shape[0]
        if n == 0:
            return np.empty(0, np.float64)
        rnds = np.asarray(rnd, np.int64)
        atts = np.asarray(attempt, np.int64)
        # the Python-int expression in _rng is exact (mod 2**63); int64
        # arithmetic is not.  Seeds stay in [0, 2**63) for any realistic
        # sim (seed >= 0, clients/rounds < ~1e9); fall back to the exact
        # per-call path if any element could wrap past 2**63 (hi bound)
        # or go negative (lo bound — e.g. a negative WirelessNetwork
        # seed).  A subclass that overrides the scalar sampler (test
        # scenarios) must keep its semantics, so it also takes the
        # per-call path.
        base = self.seed * 1_000_003
        hi = (base + int(cl.max()) * 9_176 + int(rnds.max()) * 131
              + int(atts.max()))
        lo = (base + int(cl.min()) * 9_176 + int(rnds.min()) * 131
              + int(atts.min()))
        if (hi >= 2 ** 63 or lo < 0
                or type(self).delay is not WirelessNetwork.delay):
            return np.asarray(
                [self.delay(int(c), int(r), int(a)) for c, r, a in
                 zip(cl, np.broadcast_to(rnds, cl.shape),
                     np.broadcast_to(atts, cl.shape))])
        seeds = (self.seed * 1_000_003 + cl * 9_176 + rnds * 131 + atts)
        states = _pcg64_states(seeds.astype(np.uint64))
        out = np.empty(n, np.float64)
        bg = np.random.PCG64(0)
        rng = np.random.Generator(bg)
        sdict = {"bit_generator": "PCG64",
                 "state": {"state": 0, "inc": 0},
                 "has_uint32": 0, "uinteger": 0}
        inner = sdict["state"]
        means = self.means.tolist()
        std, mu = self.delay_std, self.mu
        lo, hi = self.failure_delay
        check_fail = mu > 0.0
        for i, c in enumerate(cl.tolist()):
            inner["state"], inner["inc"] = states[i]
            bg.state = sdict
            base = rng.normal(means[c], std)
            if base < 0.1:
                base = 0.1
            if check_fail and rng.random() < mu:
                base += rng.uniform(lo, hi)
            out[i] = base
        return out

    def expected_mean(self, client: int) -> float:
        return float(self.means[client])
