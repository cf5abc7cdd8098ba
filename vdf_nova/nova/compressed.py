"""Constant-size compressed proof for the two-curve IVC.

Reference capability: nova-snark's CompressedSNARK with
``spartan_with_ipa_pc`` (used at /root/reference/src/nova/proof.rs:32-43,
360-368): the O(1)-size RecursiveSNARK still carries the two relaxed
*witness* vectors; compression replaces them with Spartan(+IPA)
arguments so the serialized proof is a few dozen field elements / points
/ sumcheck messages — **independent of both the chain length n and the
witness size**.

Protocol (mirrors nova-snark CompressedSNARK::prove, which performs one
last NIFS fold of the dangling strict secondary instance before the two
Spartan arguments):

  prove:
    1. fold ``l_u_secondary`` into ``r_U_secondary``  → (U_sec', W_sec',
       comm_T).  After this there are exactly TWO relaxed instances.
    2. Spartan-prove (W, E) for the primary accumulator over Fq /
       Pallas commitments, and for the folded secondary accumulator
       over Fp / Vesta commitments.
  verify:
    1. the same three state-hash checks as ``ivc_verify`` (O(1));
    2. re-derive the final fold challenge from (digest, r_U_secondary,
       l_u_secondary, comm_T) and refold the *instance* only;
    3. verify both Spartan arguments against the two relaxed instances.

The closing fold runs on the side's data plane; both Spartan arguments
run on the host-int tier (``_prove_side``); the instance-side refold is
host-int (it is a handful of scalar ops).
"""

from __future__ import annotations

import dataclasses

from ..poseidon.int_poseidon import IntTranscript
from ..spartan.host import (
    host_spartan_prove,
    host_spartan_verify,
    spartan_from_device,
    spartan_to_device,
)
from ..spartan.snark import SpartanProof
from .ivc import (
    HostInstance,
    HostRelaxedInstance,
    IVCParams,
    IVCProof,
    Side,
    fold_challenge,
    state_hash,
)
from .augmented import HASH_BITS


def _spartan_transcript_ints(side: Side, digest: int) -> IntTranscript:
    tr = IntTranscript(side.field.params.name)
    tr.absorb(digest)
    tr.flush()
    return tr


def _prove_side(side: Side, digest: int, U: HostRelaxedInstance, W, E) -> SpartanProof:
    """One Spartan argument on the host-int tier (native C++ MSMs), on
    either data plane: device witness handles are decoded first.

    The device tier (spartan/snark.py) emits the same proof bit for bit,
    but it compiles one executable per sumcheck and IPA round size; cold
    on an H100 its first argument alone ran past 220 s, while the host
    tier proves and verifies both arguments in ~31 s (PERF.md)."""
    f = side.field
    W_ints = W if isinstance(W, list) else f.decode(W)
    E_ints = E if isinstance(E, list) else f.decode(E)
    hp = host_spartan_prove(side, U, W_ints, E_ints, _spartan_transcript_ints(side, digest))
    return spartan_to_device(side, hp)


def _verify_side(side: Side, digest: int, U: HostRelaxedInstance, sp: SpartanProof) -> bool:
    return host_spartan_verify(
        side, U, spartan_from_device(side, sp), _spartan_transcript_ints(side, digest)
    )


@dataclasses.dataclass
class CompressedIVCProof:
    """Constant-size proof: three instances + one cross-term commitment
    + two Spartan arguments.  No witness vectors, no per-step data —
    size is independent of the number of IVC steps AND of the witness
    length (reference CompressedSNARK, proof.rs:52-55, 360-368)."""

    i: int
    z0: list[int]
    z_i: list[int]
    r_U_primary: HostRelaxedInstance
    r_U_secondary: HostRelaxedInstance
    l_u_secondary: HostInstance
    comm_t_final: tuple | None  # cross term of the closing secondary fold
    spartan_primary: SpartanProof
    spartan_secondary: SpartanProof


def ivc_compress(pp: IVCParams, proof: IVCProof) -> CompressedIVCProof:
    """CompressedSNARK::prove equivalent (proof.rs:360-368)."""
    d = pp.digest

    # 1. the closing fold: absorb the dangling strict instance.
    U_sec_fin, W_sec_fin, E_sec_fin, comm_t, _ = pp.secondary.fold(
        d,
        proof.r_U_secondary,
        proof.r_W_secondary,
        proof.r_E_secondary,
        proof.l_u_secondary,
        proof.l_w_secondary,
    )

    # 2. Spartan arguments over the two final relaxed instances.
    sp_p = _prove_side(
        pp.primary, d, proof.r_U_primary, proof.r_W_primary, proof.r_E_primary
    )
    sp_s = _prove_side(pp.secondary, d, U_sec_fin, W_sec_fin, E_sec_fin)

    return CompressedIVCProof(
        proof.i,
        list(proof.z0),
        [int(v) for v in proof.z_i],
        proof.r_U_primary,
        proof.r_U_secondary,
        proof.l_u_secondary,
        comm_t,
        sp_p,
        sp_s,
    )


def ivc_verify_compressed(
    pp: IVCParams,
    proof: CompressedIVCProof,
    num_steps: int,
    z0: list[int],
    zn: list[int],
) -> bool:
    """CompressedSNARK::verify equivalent (proof.rs:370-387): O(1) hash
    checks + instance refold + two Spartan verifications; touches no
    witness vectors and nothing sized by num_steps."""
    if num_steps == 0 or proof.i != num_steps:
        return False
    p = pp.primary.field.params.modulus
    z0 = [int(v) % p for v in z0]
    zn = [int(v) % p for v in zn]
    if proof.z0 != z0 or [int(v) % p for v in proof.z_i] != zn:
        return False

    d = pp.digest
    # chain invariant (same as ivc_verify).
    if proof.l_u_secondary.X[0] != state_hash(
        "Fq", d, num_steps, z0, zn, proof.r_U_secondary
    ):
        return False
    if proof.l_u_secondary.X[1] != state_hash(
        "Fp", d, num_steps, [0], [0], proof.r_U_primary
    ):
        return False
    for U in (proof.r_U_primary, proof.r_U_secondary):
        if not (0 <= U.u < (1 << HASH_BITS)):
            return False

    # re-derive the closing fold (instance side only).
    r = fold_challenge(
        pp.secondary.tr_field, d, proof.r_U_secondary, proof.l_u_secondary, proof.comm_t_final
    )
    U_sec_fin = pp.secondary.fold_instance(
        proof.r_U_secondary, proof.l_u_secondary, proof.comm_t_final, r
    )

    ok_p = _verify_side(pp.primary, d, proof.r_U_primary, proof.spartan_primary)
    ok_s = _verify_side(pp.secondary, d, U_sec_fin, proof.spartan_secondary)
    return ok_p and ok_s
