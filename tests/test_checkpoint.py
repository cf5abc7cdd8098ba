"""Checkpoint/resume tests (SURVEY §5 checkpoint row).

An interrupted IVC prover resumed from a checkpoint file must produce
byte-identical proofs to an uninterrupted run; corrupted checkpoints
must fail closed.  The VDF (state, t) checkpoint mirrors the
``Evaluation.append`` seam (/root/reference/src/minroot.rs:428-438).
"""

from __future__ import annotations

import pytest

from vdf_nova.checkpoint import (
    load_ivc,
    load_vdf,
    resume_ivc,
    save_ivc,
    save_vdf,
)
from vdf_nova.errors import SerializationError
from vdf_nova.fields.int_field import get_int_field
from vdf_nova.nova.ivc import RecursiveIVC, ivc_public_params, ivc_verify
from vdf_nova.serialize import serialize_ivc_proof

T, N = 2, 4


def _forward(x, y, i, total):
    f = get_int_field("Fq")
    e = pow(5, -1, f.p - 1)
    for _ in range(total):
        x, y, i = pow((x + y) % f.p, e, f.p), (x + i) % f.p, i + 1
    return [x, y, i]


@pytest.fixture(scope="module")
def pp():
    return ivc_public_params(T, engine="native")


def test_ivc_checkpoint_resume_identical(pp, tmp_path):
    start = (42, 0, 0)
    z0 = _forward(*start, N * T)

    # uninterrupted run
    ivc_full = RecursiveIVC(pp, z0)
    for _ in range(N - 1):
        ivc_full.prove_step()
    want = serialize_ivc_proof(pp, ivc_full.proof())

    # interrupted at step 2: checkpoint, "crash", resume, continue
    ivc_a = RecursiveIVC(pp, z0)
    ivc_a.prove_step()
    ckpt = tmp_path / "ivc.ckpt"
    save_ivc(str(ckpt), pp, ivc_a)
    del ivc_a

    ivc_b = resume_ivc(str(ckpt), pp)
    assert ivc_b.i == 2
    for _ in range(N - 2):
        ivc_b.prove_step()
    got = serialize_ivc_proof(pp, ivc_b.proof())
    assert got == want, "resumed proof differs from uninterrupted proof"
    assert ivc_verify(pp, ivc_b.proof(), N, z0, list(start))


def test_ivc_checkpoint_is_verified_on_resume(pp, tmp_path):
    start = (7, 0, 0)
    z0 = _forward(*start, N * T)
    ivc = RecursiveIVC(pp, z0)
    ivc.prove_step()
    ckpt = tmp_path / "ivc.ckpt"
    save_ivc(str(ckpt), pp, ivc)

    # flip one byte in the body: decode or verify must reject.
    blob = bytearray(ckpt.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(bytes(blob))
    with pytest.raises(SerializationError):
        resume_ivc(str(bad), pp)

    # truncation fails closed in the codec.
    trunc = tmp_path / "trunc.ckpt"
    trunc.write_bytes(ckpt.read_bytes()[:-10])
    with pytest.raises(SerializationError):
        load_ivc(str(trunc), pp)


def test_vdf_checkpoint_roundtrip(tmp_path):
    from vdf_nova.minroot import Evaluation, pallas_vdf

    vdf = pallas_vdf()
    s0 = vdf.state_from_ints([5, 6], [0, 0], [0, 0])
    _, proof1 = Evaluation.eval(vdf, s0, 3)
    path = tmp_path / "vdf.ckpt"
    save_vdf(str(path), "Fq", proof1.result, proof1.t)

    field_name, state, t = load_vdf(str(path))
    assert field_name == "Fq" and t == 3
    # continue from the checkpointed state and verify the joint chain.
    _, proof2 = Evaluation.eval(vdf, state, 3)
    joint = proof1.append(proof2)
    assert joint is not None and joint.t == 6 and joint.verify(s0)

    # tampered element fails closed.
    blob = bytearray(path.read_bytes())
    blob[-1] = 0xFF
    bad = tmp_path / "bad_vdf.ckpt"
    bad.write_bytes(bytes(blob))
    with pytest.raises(SerializationError):
        load_vdf(str(bad))
