"""Constant-size compressed IVC proof + byte serialization tests.

Mirrors the reference CompressedSNARK usage (test_nova_proof,
/root/reference/src/nova/proof.rs:443-450): compress the recursive proof,
verify the compressed form, and additionally round-trip both proof kinds
through the canonical byte codec (new capability — the reference keeps
proofs in-process)."""

import dataclasses

import pytest

from vdf_nova.errors import SerializationError
from vdf_nova.fields.int_field import get_int_field
from vdf_nova.nova.compressed import ivc_compress, ivc_verify_compressed
from vdf_nova.nova.ivc import RecursiveIVC, ivc_public_params, ivc_verify
from vdf_nova.serialize import (
    deserialize_compressed,
    deserialize_ivc_proof,
    serialize_compressed,
    serialize_ivc_proof,
)

T, N = 2, 3


def forward_eval(x: int, y: int, i: int, total: int):
    f = get_int_field("Fq")
    invalpha = pow(5, -1, f.p - 1)
    for _ in range(total):
        x, y, i = pow((x + y) % f.p, invalpha, f.p), (x + i) % f.p, i + 1
    return x, y, i


@pytest.fixture(scope="module")
def compressed():
    pp = ivc_public_params(T, engine="native")
    start = (5, 6, 0)
    z0 = list(forward_eval(*start, N * T))
    ivc = RecursiveIVC(pp, z0)
    for _ in range(N - 1):
        ivc.prove_step()
    proof = ivc.proof()
    cp = ivc_compress(pp, proof)
    return pp, proof, cp, z0, list(start)


class TestCompressed:
    def test_verifies(self, compressed):
        pp, _, cp, z0, zn = compressed
        assert ivc_verify_compressed(pp, cp, N, z0, zn)

    def test_wrong_claim_rejected(self, compressed):
        pp, _, cp, z0, zn = compressed
        assert not ivc_verify_compressed(pp, cp, N + 1, z0, zn)
        bad = dataclasses.replace(cp, z_i=[1, 2, 3])
        assert not ivc_verify_compressed(pp, bad, N, z0, [1, 2, 3])

    def test_tampered_instance_rejected(self, compressed):
        pp, _, cp, z0, zn = compressed
        U = cp.r_U_primary
        bad = dataclasses.replace(
            cp, r_U_primary=dataclasses.replace(U, X=[(U.X[0] + 1) % (1 << 255), U.X[1]])
        )
        assert not ivc_verify_compressed(pp, bad, N, z0, zn)

    def test_tampered_spartan_rejected(self, compressed):
        pp, _, cp, z0, zn = compressed
        sp = cp.spartan_primary
        f = pp.primary.field
        bumped = f.add(sp.vA, f.encode(1))
        bad = dataclasses.replace(cp, spartan_primary=sp._replace(vA=bumped))
        assert not ivc_verify_compressed(pp, bad, N, z0, zn)

    def test_constant_size_in_n(self, compressed):
        """Serialized size is independent of chain length: prove a longer
        chain and compare byte counts (reference CompressedSNARK property,
        proof.rs:360-368)."""
        pp, _, cp, z0, zn = compressed
        blob = serialize_compressed(pp, cp)

        # a longer chain from scratch for a clean comparison
        start = (9, 1, 0)
        z0b = list(forward_eval(*start, (N + 2) * T))
        ivc = RecursiveIVC(pp, z0b)
        for _ in range(N + 1):
            ivc.prove_step()
        cp2 = ivc_compress(pp, ivc.proof())
        assert ivc_verify_compressed(pp, cp2, N + 2, z0b, list(start))
        blob2 = serialize_compressed(pp, cp2)
        assert len(blob2) == len(blob)


class TestSerialization:
    def test_ivc_roundtrip(self, compressed):
        pp, proof, _, z0, zn = compressed
        blob = serialize_ivc_proof(pp, proof)
        back = deserialize_ivc_proof(pp, blob)
        assert ivc_verify(pp, back, N, z0, zn)
        assert serialize_ivc_proof(pp, back) == blob

    def test_compressed_roundtrip(self, compressed):
        pp, _, cp, z0, zn = compressed
        blob = serialize_compressed(pp, cp)
        back = deserialize_compressed(pp, blob)
        assert ivc_verify_compressed(pp, back, N, z0, zn)
        assert serialize_compressed(pp, back) == blob

    def test_malformed_rejected(self, compressed):
        pp, proof, cp, _, _ = compressed
        blob = serialize_ivc_proof(pp, proof)
        with pytest.raises(SerializationError):
            deserialize_ivc_proof(pp, b"XXXXXXXX" + blob[8:])
        with pytest.raises(SerializationError):
            deserialize_ivc_proof(pp, blob[:-1])
        with pytest.raises(SerializationError):
            deserialize_ivc_proof(pp, blob + b"\x00")
        # non-canonical element: patch a field element to >= modulus
        with pytest.raises(SerializationError):
            bad = bytearray(serialize_compressed(pp, cp))
            bad[-32:] = (get_int_field("Fq").p + 1).to_bytes(32, "little")
            deserialize_compressed(pp, bytes(bad))
import pytest as _pytest

pytestmark = _pytest.mark.slow  # heavy XLA compiles: slow CI lane
