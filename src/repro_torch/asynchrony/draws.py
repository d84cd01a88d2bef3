"""Where the engine's random draws come from.

The reference draws with ``jax.random``, which torch cannot reproduce, and
torch's own generators give different numbers on the CPU and the card.
So every draw of the port is a function of ``(seed, tick, stream, index)``
through an integer hash written in torch integer ops: the same bits on the
CPU and the card, and a lane's draws do not depend on which other lanes
share its batch.  There is no global random state.

A *source* serves two kinds of draws, through a :class:`Draw` (one
tick's draws for every lane):

- ``bits(key, stream, shape)``: 32 random bits per element, ``[B,
  *shape]``, from the lanes' ``key(seed [B], tick [B])`` (the delay
  models' activity and delays);
- ``markers(draw, p, max_delay)``: a snapshot's marker delays ``[B, p]``
  and its reply delay ``[B]``, each uniform in ``0..max_delay``.

:class:`CounterSource` is the engine's default.  :class:`TableSource`
serves marker delays from a table (the parity tests compute the
reference's with its own key chain) and no bits.
"""

from __future__ import annotations

import functools
import math

import torch

MASK = 0xFFFFFFFF

# streams: one per kind of draw, so no two kinds share bits
ACTIVE, DELAYS, TAIL, START, WHO, MARKERS, REPLY, RHS = range(1, 9)


def _mix(h):
    """A 32-bit integer hash (low-bias multiply-xorshift) on int64 tensors
    holding values below 2**32; both multipliers are below 2**31, so no
    product leaves the int64 range."""
    h = h ^ (h >> 16)
    h = (h * 0x21F0AAAD) & MASK
    h = h ^ (h >> 15)
    h = (h * 0x735A2D97) & MASK
    return h ^ (h >> 15)


@functools.lru_cache(maxsize=256)
def _index_hash(stream: int, numel: int, device) -> torch.Tensor:
    """``hash(stream, index)`` of every element of a draw, made once."""
    return _mix(torch.arange(numel, dtype=torch.int64, device=device) + (stream << 24))


class CounterSource:
    """Counter-based draws: ``hash(key ^ hash(stream, index))`` with
    ``key = hash(hash(seed) ^ tick)``."""

    def key(self, seed, tick):
        return _mix(_mix(seed.long() & MASK) ^ (tick.long() & MASK))

    def bits(self, key, stream: int, shape=()):
        h = _mix(key[:, None] ^ _index_hash(stream, math.prod(shape), key.device)[None, :])
        return h.reshape(key.shape + tuple(shape))

    def markers(self, draw: "Draw", p: int, max_delay: int):
        return draw.randint(MARKERS, (p,), max_delay + 1), draw.randint(REPLY, (), max_delay + 1)


class TableSource:
    """Marker delays from tables indexed by tick: ``markers [T, p]`` and
    ``reply [T]``.  It serves no bits, so it runs with the ``trace`` delay
    model (or ``sync``, which draws none)."""

    def __init__(self, markers, reply):
        self.markers_table = torch.tensor(markers, dtype=torch.int32)
        self.reply_table = torch.tensor(reply, dtype=torch.int32)

    def key(self, seed, tick):
        return None

    def bits(self, key, stream: int, shape=()):
        raise ValueError("a table source serves marker delays only: run it with the "
                         "'trace' delay model")

    def markers(self, draw: "Draw", p: int, max_delay: int):
        t = draw.tick.long().cpu()
        return (self.markers_table[t].to(draw.tick.device),
                self.reply_table[t].to(draw.tick.device))


def uniform(bits):
    """fp32 in [0, 1) from 24 of the bits (exact on every device)."""
    return (bits >> 8).float() * (2.0 ** -24)


def randint(bits, high: int):
    """Integers in ``0..high-1`` from 24 of the bits, in integer ops."""
    return ((bits >> 8) * high) >> 24


def uniform_table(seed: int, n: int):
    """``[n]`` fp32 uniforms in [0, 1) for data made from a seed (a
    solver's right-hand side), from the counter-based source at tick 0."""
    zero = torch.zeros(1, dtype=torch.int64)
    return Draw(CounterSource(), zero + seed, zero).uniform(RHS, (n,))[0]


class Draw:
    """One tick's draws for every lane: ``source`` bound to the lanes'
    seeds and ticks (their key is hashed once, at the first draw)."""

    def __init__(self, source, seed, tick):
        self.source, self.seed, self.tick = source, seed, tick

    @functools.cached_property
    def key(self):
        return self.source.key(self.seed, self.tick)

    def bits(self, stream: int, shape=()):
        return self.source.bits(self.key, stream, shape)

    def uniform(self, stream: int, shape=()):
        return uniform(self.bits(stream, shape))

    def randint(self, stream: int, shape, high: int):
        return randint(self.bits(stream, shape), high).int()

    def bernoulli(self, stream: int, prob, shape=()):
        """``uniform < prob``; ``prob`` broadcasts against ``[B, *shape]``."""
        return self.uniform(stream, shape) < prob

    def markers(self, p: int, max_delay: int):
        """A snapshot's marker delays ``[B, p]`` and reply delay ``[B]``."""
        return self.source.markers(self, p, max_delay)
