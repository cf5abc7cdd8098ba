"""Poseidon permutation/sponge tests vs an exact Python-int oracle."""

import numpy as np
import pytest

from vdf_nova.fields import FP, FQ, get_field
from vdf_nova.poseidon import (
    FULL_ROUNDS,
    Transcript,
    generate_constants,
    get_poseidon,
    hash_fixed,
    partial_rounds,
)


def oracle_permute(p, rc, mds, state):
    width = len(state)
    r_p = partial_rounds(width)
    rc = list(rc)
    idx = 0

    def add_rc(s):
        nonlocal idx
        out = [(x + rc[idx + k]) % p for k, x in enumerate(s)]
        idx += width
        return out

    def sbox(x):
        return pow(x, 5, p)

    def mds_mul(s):
        return [sum(mds[i][j] * s[j] for j in range(width)) % p for i in range(width)]

    half = FULL_ROUNDS // 2
    for _ in range(half):
        state = mds_mul([sbox(x) for x in add_rc(state)])
    for _ in range(r_p):
        state = add_rc(state)
        state = mds_mul([sbox(state[0])] + state[1:])
    for _ in range(half):
        state = mds_mul([sbox(x) for x in add_rc(state)])
    return state


@pytest.mark.parametrize("field_name,P", [("Fq", FQ), ("Fp", FP)])
@pytest.mark.parametrize("width", [3, 5])
def test_permutation_matches_oracle(field_name, P, width):
    pos = get_poseidon(field_name, width)
    f = pos.field
    p = P.modulus
    state_ints = [(k * 7919 + 13) % p for k in range(width)]
    state = [f.encode([v, v]) for v in state_ints]  # batch of 2 lanes
    out = pos.permute(state)
    rc, mds = generate_constants(field_name, width)
    want = oracle_permute(p, rc, mds, state_ints)
    for k in range(width):
        assert f.decode(out[k]) == [want[k], want[k]]


def test_constants_deterministic_and_distinct():
    rc1, mds1 = generate_constants("Fq", 3)
    rc2, _ = generate_constants("Fq", 3)
    assert rc1 == rc2  # deterministic
    rc_w4, _ = generate_constants("Fq", 4)
    assert rc1[: len(rc_w4)] != rc_w4  # width feeds the Grain seed
    assert len(set(rc1)) == len(rc1)  # no degenerate stream
    assert all(v < FQ.modulus for v in rc1)


def test_hash_fixed():
    f = get_field("Fq")
    a, b = f.encode([5]), f.encode([7])
    h1 = hash_fixed("Fq", [a, b])
    h2 = hash_fixed("Fq", [a, b])
    h3 = hash_fixed("Fq", [b, a])
    assert f.decode(h1) == f.decode(h2)
    assert f.decode(h1) != f.decode(h3)


def test_transcript_determinism_and_binding():
    f = get_field("Fq")

    def run(vals):
        tr = Transcript("Fq")
        tr.absorb(*[f.encode([v]) for v in vals])
        return f.decode(tr.squeeze())

    assert run([1, 2, 3]) == run([1, 2, 3])
    assert run([1, 2, 3]) != run([1, 2, 4])

    tr = Transcript("Fq")
    tr.absorb(f.encode([9]))
    c1 = f.decode(tr.squeeze())
    c2 = f.decode(tr.squeeze())
    assert c1 != c2  # successive squeezes differ
