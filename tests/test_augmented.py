"""Direct host <-> in-circuit transcript parity.

The O(1) IVC verifier trusts that the host control plane (nova/ivc.py
``state_hash`` / ``fold_challenge`` over IntTranscript) and the
augmented circuit's transcript gadget (nova/gadgets/sponge.py +
gadgets/instance.py encodings) absorb byte-identical element sequences.
Until now that parity was only exercised end-to-end (a framing change
surfaced as a 68-second IVC failure); these unit tests localize it.

Reference analog: nova-snark's RO consistency between its native
PoseidonRO and the in-circuit PoseidonROCircuit (used from
/root/reference/src/nova/proof.rs:342-349 via prove_step).
"""

from __future__ import annotations

import pytest

from vdf_nova.curves.point import hash_to_curve_ints
from vdf_nova.fields.int_field import get_int_field
from vdf_nova.nova.augmented import CHALLENGE_BITS, HASH_BITS, _truncated_squeeze
from vdf_nova.nova.gadgets.instance import (
    AllocatedInstance,
    AllocatedRelaxedInstance,
    _alloc_num,
)
from vdf_nova.nova.gadgets.ec import AllocatedPoint
from vdf_nova.nova.gadgets.sponge import TranscriptGadget
from vdf_nova.nova.ivc import (
    HostInstance,
    HostRelaxedInstance,
    fold_challenge,
    state_hash,
)
from vdf_nova.r1cs.witness import WitnessCS

# Each side's circuit field and the curve whose points it handles
# natively (the OTHER side's commitment curve).
SIDES = [("Fq", "vesta"), ("Fp", "pallas")]


def _fixture_instances(curve_name: str, field_name: str):
    pts = hash_to_curve_ints(curve_name, 4, domain=b"test_augmented")
    p_other = get_int_field({"Fq": "Fp", "Fp": "Fq"}[field_name]).p
    U = HostRelaxedInstance(
        comm_w=pts[0],
        comm_e=pts[1],
        X=[0x1234567890ABCDEF << 100 | 0x77, (p_other - 5) % p_other],
        u=(1 << 200) + 12345,
    )
    u = HostInstance(comm_w=pts[2], X=[(1 << HASH_BITS) - 3, 0xDEADBEEF << 64])
    comm_t = pts[3]
    return U, u, comm_t


@pytest.mark.parametrize("field_name,curve_name", SIDES)
def test_state_hash_parity(field_name, curve_name):
    """Host state_hash == the circuit's h_in transcript output."""
    f = get_int_field(field_name)
    U, _, _ = _fixture_instances(curve_name, field_name)
    d, i = 0xABCDEF0123456789, 7
    z0 = [3, 0, 0] if field_name == "Fq" else [0]
    z_i = [11, 22, 33] if field_name == "Fq" else [0]

    want = state_hash(field_name, d, i, z0, z_i, U)

    cs = WitnessCS(f, inputs=[], check=True)
    d_n = _alloc_num(cs, "params", d)
    i_n = _alloc_num(cs, "i", i)
    z0_n = [_alloc_num(cs, f"z0_{k}", v) for k, v in enumerate(z0)]
    zi_n = [_alloc_num(cs, f"zi_{k}", v) for k, v in enumerate(z_i)]
    U_g = AllocatedRelaxedInstance.alloc(cs, "U", U)
    tr = TranscriptGadget(cs, field_name, name="hin")
    tr.absorb(d_n, i_n, *z0_n, *zi_n, *U_g.parts().absorb_elements())
    h, _ = _truncated_squeeze(cs, tr, HASH_BITS, "hin")

    assert not cs.failed, cs.failed[:5]
    assert h.value == want


@pytest.mark.parametrize("field_name,curve_name", SIDES)
def test_fold_challenge_parity(field_name, curve_name):
    """Host fold_challenge == the circuit's RO transcript output."""
    f = get_int_field(field_name)
    U, u, comm_t = _fixture_instances(curve_name, field_name)
    d = 0x1122334455667788

    want = fold_challenge(field_name, d, U, u, comm_t)

    cs = WitnessCS(f, inputs=[], check=True)
    d_n = _alloc_num(cs, "params", d)
    U_g = AllocatedRelaxedInstance.alloc(cs, "U", U)
    u_g = AllocatedInstance.alloc(cs, "u", u)
    t_g = AllocatedPoint.alloc(cs, "comm_t", comm_t)
    tr = TranscriptGadget(cs, field_name, name="ro")
    tr.absorb(
        d_n,
        *U_g.parts().absorb_elements(),
        *u_g.absorb_elements(),
        *t_g.absorb_elements(),
    )
    r, bits = _truncated_squeeze(cs, tr, CHALLENGE_BITS, "r")

    assert not cs.failed, cs.failed[:5]
    assert r.value == want
    assert len(bits) == CHALLENGE_BITS


@pytest.mark.parametrize("field_name,curve_name", SIDES)
def test_identity_point_encoding_parity(field_name, curve_name):
    """None (identity) commitments hash identically host vs circuit."""
    f = get_int_field(field_name)
    U = HostRelaxedInstance.default()
    d, i = 99, 0
    z0 = [5] if field_name == "Fp" else [1, 2, 3]
    want = state_hash(field_name, d, i, z0, z0, U)

    cs = WitnessCS(f, inputs=[], check=True)
    d_n = _alloc_num(cs, "params", d)
    i_n = _alloc_num(cs, "i", i)
    z_n = [_alloc_num(cs, f"z_{k}", v) for k, v in enumerate(z0)]
    U_g = AllocatedRelaxedInstance.alloc(cs, "U", U)
    tr = TranscriptGadget(cs, field_name, name="hin")
    tr.absorb(d_n, i_n, *z_n, *z_n, *U_g.parts().absorb_elements())
    h, _ = _truncated_squeeze(cs, tr, HASH_BITS, "hin")

    assert not cs.failed, cs.failed[:5]
    assert h.value == want
