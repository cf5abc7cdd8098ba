"""Frozen-constants golden vectors (SURVEY §7.3 risk 2, BASELINE
"bit-exact" target).

The environment has no network and no Rust toolchain, so neptune /
nova-snark golden vectors cannot be produced here (documented in
docs/ARCHITECTURE.md); instead THIS framework's own constants are frozen with
versioned digests so any accidental change to the Poseidon parameter
generation, transcript framing, MDS derivation, or augmented-circuit
shape breaks loudly.  Constants are a single swap point
(poseidon/params.py) if upstream vectors become available later.
"""

import hashlib

import pytest

from vdf_nova.poseidon.int_poseidon import IntTranscript, permute_ints
from vdf_nova.poseidon.params import generate_constants

POSEIDON_DIGESTS = {
    ("Fp", 3): "01002673b0cbc3d30f06f36a46750ab0d7b2afaaeee8e8970b097131e7123b26",
    ("Fp", 5): "424c814b8b12229fd6ce2ea33ce558c75f0dce611b7007194fb0b5bdf6ebff61",
    ("Fq", 3): "1eb9bf6c566b7ac0fe115315703c6febcff92c0515eeb527e910a8efc4ca2032",
    ("Fq", 5): "163980e8d9032d129ccbd492404672a863fc6235f64e154d0c3bb95cae63da6d",
}

PERMUTE_STATE0 = {
    ("Fp", 3): 0xA070019374AD8A80F58621B488C888EBEAA8568D6DEB965179DF980D437DAD6,
    ("Fp", 5): 0x2B5FCC0D26105F3F6017EF5F7D9DC5CCDC8E1A22D9D60EDF126B37ACAD689667,
    ("Fq", 3): 0x1B80FEFCE1DACF419D85C2493DCC5E94760429C18198991DC58DA32A9A127194,
    ("Fq", 5): 0x362BA55BD8233AE8C55AC13BC64F8A17746D84CAC88F85AD9FEA36E96B8BE740,
}

TRANSCRIPT_CHALLENGES = {
    "Fp": (
        0x3DD5F3FF7A158818052D121349BF4BBE08155A4F7484707387EFE17833C6EE77,
        0x30D8AE8BEF5EDCE48718E8970E0E2CC65BBC07137924D9A6C603336FFFA6DD2,
    ),
    "Fq": (
        0x2D48C5E236B2315AACEEA7EEEA38C8E69A5DB0716DCB690041658DC8CA320349,
        0x6B1A9BB369109F4237A13B8B78FD5C475D559556B61FBCECD84A1A353F675CA,
    ),
}

# IVC public-params digests: pin the full augmented-circuit R1CS of both
# curve sides and the commitment-key label (any constraint/coefficient
# or key-domain change re-derives these).
PP_DIGESTS = {
    1: 0x2B1BB4E4034251D7C3B6F2926D2E435419071150B6067E0240C206FCB169538,
    2: 0x3FC4983066A7FC98AAC69DEB93C407E5283BC14E1479E1BD948200D8B3296F3,
}

# sha256 over the first 16 commitment-key generators (affine x, y as
# 32-byte LE) of each curve: pins the key derivation under CK_LABEL.
CK_DIGESTS = {
    "pallas": "ff315305aeedc0305ae19b3c00c3abb2586c2e2ab6061a180ac863520b6d36c1",
    "vesta": "3002a5d3e901084a04cfae4dc5652eb7f136cb6a75440c07dde1dceecb63f618",
}


@pytest.mark.parametrize("field,width", list(POSEIDON_DIGESTS))
def test_poseidon_constants_frozen(field, width):
    rc, mds = generate_constants(field, width)
    h = hashlib.sha256()
    for v in rc:
        h.update(int(v).to_bytes(32, "little"))
    for row in mds:
        for v in row:
            h.update(int(v).to_bytes(32, "little"))
    assert h.hexdigest() == POSEIDON_DIGESTS[(field, width)]


@pytest.mark.parametrize("field,width", list(PERMUTE_STATE0))
def test_permutation_vector_frozen(field, width):
    st = permute_ints(field, list(range(width)), width)
    assert st[0] == PERMUTE_STATE0[(field, width)]


@pytest.mark.parametrize("field", ["Fp", "Fq"])
def test_transcript_challenges_frozen(field):
    tr = IntTranscript(field)
    tr.absorb(1, 2, 3, 4, 5, 6, 7)
    assert (tr.squeeze(), tr.squeeze()) == TRANSCRIPT_CHALLENGES[field]


@pytest.mark.parametrize("t", [1, 2])
def test_ivc_params_digest_frozen(t):
    from vdf_nova.nova.ivc import ivc_public_params

    assert ivc_public_params(t, engine="native").digest == PP_DIGESTS[t]


@pytest.mark.parametrize("curve", list(CK_DIGESTS))
def test_commitment_key_frozen(curve):
    from vdf_nova.curves.point import hash_to_curve_ints
    from vdf_nova.nova.pedersen import CK_LABEL

    h = hashlib.sha256()
    for x, y in hash_to_curve_ints(curve, 16, domain=CK_LABEL):
        h.update(x.to_bytes(32, "little"))
        h.update(y.to_bytes(32, "little"))
    assert h.hexdigest() == CK_DIGESTS[curve]


def test_ivc_params_digest_covers_key_label(monkeypatch):
    from vdf_nova.nova import ivc

    shape = ivc.ivc_public_params(1, engine="native").primary.shape
    before = ivc._params_digest(shape)
    monkeypatch.setattr(ivc, "CK_LABEL", b"another/ck")
    assert ivc._params_digest(shape) != before
