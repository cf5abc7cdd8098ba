"""Pipeline-parallel proving tests (SURVEY §2.4 PP axis).

The pipelined prover must be a pure scheduling change: proofs out of
the two-stage pipeline are bit-identical to the sequential reference
execution model (eval then fold per statement,
/root/reference/src/nova/proof.rs:262-298,316-355) and verify the same.
"""

import pytest

from vdf_nova.fields.int_field import get_int_field
from vdf_nova.minroot import pallas_vdf
from vdf_nova.nova.ivc import ivc_public_params, ivc_verify
from vdf_nova.nova.pipeline import VDFStatement, prove_stream
from vdf_nova.utils import TEST_SEED, XorShiftRng, field_random

T = 2  # iters per IVC step


@pytest.fixture(scope="module")
def pp():
    return ivc_public_params(T, engine="native")


@pytest.fixture(scope="module")
def statements():
    rng = XorShiftRng(TEST_SEED)
    p = get_int_field("Fq").p
    return [
        VDFStatement((field_random(rng, p), 0, 1), num_steps=3),
        VDFStatement((field_random(rng, p), 0, 1), num_steps=2),
        VDFStatement((field_random(rng, p), 0, 1), num_steps=4),
    ]


@pytest.mark.slow
def test_pipelined_matches_sequential(pp, statements):
    vdf = pallas_vdf()
    seq = prove_stream(pp, statements, vdf, pipelined=False)
    pipe = prove_stream(pp, statements, vdf, pipelined=True)
    assert len(seq) == len(pipe) == len(statements)
    for s, q in zip(seq, pipe):
        assert s.statement == q.statement  # order preserved
        assert s.verified and q.verified
        assert s.z0 == q.z0
        # proofs are deterministic: the pipeline is scheduling-only
        assert s.proof.z_i == q.proof.z_i
        assert s.proof.r_U_primary == q.proof.r_U_primary
        assert s.proof.r_U_secondary == q.proof.r_U_secondary
        assert s.proof.l_u_secondary == q.proof.l_u_secondary
        # and each re-verifies against the original start state
        assert ivc_verify(
            pp, q.proof, q.statement.num_steps, q.z0, list(q.statement.start)
        )


@pytest.mark.slow
def test_interleaved_chains_match_sequential(pp):
    """prove_interleaved is scheduling-only: each chain's proof equals
    the one a lone RecursiveIVC produces, and verifies."""
    from vdf_nova.nova.ivc import RecursiveIVC
    from vdf_nova.nova.pipeline import prove_interleaved

    rng = XorShiftRng(TEST_SEED)
    p = get_int_field("Fq").p
    num_steps = 3
    starts = [(field_random(rng, p), 0, 1) for _ in range(3)]

    from vdf_nova.minroot.vdf import jit_eval
    from vdf_nova.minroot import State

    f = pp.primary.field
    z0s = []
    vdf = pallas_vdf()
    for s in starts:
        st = State(*(f.encode([v]) for v in s))
        res = jit_eval("Fq", vdf.mode.value, T * num_steps)(st)
        z0s.append([f.decode(a)[0] for a in (res.x, res.y, res.i)])

    proofs = prove_interleaved(pp, z0s, num_steps, starts=starts)
    assert len(proofs) == len(starts)
    for z0, start, proof in zip(z0s, starts, proofs):
        assert ivc_verify(pp, proof, num_steps, z0, list(start))
        solo = RecursiveIVC(pp, z0)
        for _ in range(num_steps - 1):
            solo.prove_step()
        ref = solo.proof()
        assert proof.z_i == ref.z_i
        assert proof.r_U_primary == ref.r_U_primary
        assert proof.r_U_secondary == ref.r_U_secondary
        assert proof.l_u_secondary == ref.l_u_secondary


@pytest.mark.slow
def test_pipeline_rejects_tampered_start(pp):
    vdf = pallas_vdf()
    stmt = VDFStatement((12345, 0, 1), num_steps=2)
    (res,) = prove_stream(pp, [stmt], vdf, pipelined=True)
    assert res.verified
    assert not ivc_verify(pp, res.proof, stmt.num_steps, res.z0, [54321, 0, 1])
