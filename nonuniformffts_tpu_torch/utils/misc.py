"""Host-side integer helpers (plan-construction time only)."""

from __future__ import annotations


def _is_smooth(n: int, primes=(2, 3, 5)) -> bool:
    for p in primes:
        while n % p == 0:
            n //= p
    return n == 1


def next_fast_len(n: int, primes=(2, 3, 5)) -> int:
    """Smallest integer >= n whose prime factors are all in `primes`.

    Julia's ``nextprod((2, 3, 5), n)``, which the reference uses to choose
    oversampled-grid sizes (src/plan.jl:485-498); 5-smooth sizes are also
    fast sizes for cuFFT.
    """
    if n <= 1:
        return 1
    m = n
    while not _is_smooth(m, primes):
        m += 1
    return m
