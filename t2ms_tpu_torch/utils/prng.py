"""Seed derivation (counterpart of t2ms_tpu/utils/prng.py).

The JAX package threads threefry keys and folds steps and stream names
into them. torch cannot reproduce threefry bits, so a key here is a torch
seed: a 63-bit int whose high 31 bits name a stream (the run's seed, or a
named fold of it) and whose low 32 bits hold the step. ``step_key(
root_key(seed), i)`` is the seed of the CLIs' draw i, so a run that
resumes at an optimizer step draws what the uninterrupted run would have;
``named_fold`` hashes JAX's sha256 tag of the name into a new stream.
A key seeds a generator only through ``torch_seed``: torch's CPU
generator (mt19937) keeps a seed's low 32 bits alone, and a key's stream
lives in its high word.
"""

from __future__ import annotations

import hashlib

__all__ = ["root_key", "step_key", "named_fold", "name_tag",
           "seed_everything", "torch_seed"]

_LOW = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def seed_everything(seed) -> int:
    """Seed ``random``, numpy and torch (reference utils.py:26-36) and
    return the root key. ``None`` seeds nothing and returns a root key
    drawn from OS entropy, as the JAX package does."""
    import random

    import numpy as np
    import torch
    if seed is None:
        import os
        return root_key(int.from_bytes(os.urandom(8), "little") >> 1)
    print(f"Global seed set to {seed}")
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return root_key(seed)


def root_key(seed: int) -> int:
    """The stream of run seed ``seed`` (its low 31 bits), at step 0."""
    return (int(seed) & 0x7FFFFFFF) << 32


def _stream(key: int, data) -> int:
    """A new 31-bit stream id from (key, data)."""
    h = hashlib.sha256(f"{int(key)}:{data}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def step_key(key: int, step) -> int:
    """Fold ``step`` into ``key``: a key whose step word is free (a root
    key or a named fold) takes the step there; a key that already holds a
    step is first hashed into a stream of its own."""
    key = int(key)
    if key & _LOW:
        key = _stream(key, "step") << 32
    return key | (int(step) & _LOW)


def name_tag(name: str) -> int:
    """JAX's tag of a stream name: the first 4 little-endian bytes of its
    sha256."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4],
                          "little")


def named_fold(key: int, name: str) -> int:
    """Deterministically derive a stream from a string tag."""
    return _stream(key, name_tag(name)) << 32


def torch_seed(key: int) -> int:
    """The seed that ``manual_seed`` takes for ``key``: the splitmix64
    finaliser of the key, cut to 63 bits. Every bit of the key reaches the
    low 32 bits, which are all that torch's CPU generator keeps, so two
    streams, or two steps of one, draw apart on the CPU as on the card. A
    pure function of the key: a resumed run draws what the uninterrupted
    one would."""
    z = (int(key) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1
