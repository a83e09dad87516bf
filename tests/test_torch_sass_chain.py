"""tools/sass_chain.py, which counts the dependent chain of a loop step
in `cuobjdump -sass` output (K7's chain bound), on a hand-written
listing: the loop found, the slow path's call skipped, the latencies
added along the register and shared-memory dependences."""

import pytest

from tpuslam_torch.tools import sass_chain as C

LISTING = """
        code for sm_90a
                Function : _Z6kernelILi0EEvv
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;    /* 0x00000a0000017a02 */
                                                             /* 0x000fc40000000f00 */
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/                   MUFU.RSQ R4, R2 ;
        /*0030*/                   FMUL R5, R4, R2 ;
        /*0040*/                   FCHK P0, R5, R2 ;
        /*0050*/              @!P0 BRA 0x90 ;
        /*0060*/                   MOV R6, R5 ;
        /*0070*/                   CALL.REL.NOINC 0x200 ;
        /*0080*/                   MOV R5, R6 ;
        /*0090*/                   FADD R7, R5, R5 ;
        /*00a0*/              @P2  FADD R9, R7, R7 ;
        /*00b0*/                   STS [R3], R9 ;
        /*00c0*/                   ISETP.GE.AND P1, PT, R8, 0x10, PT ;
        /*00d0*/              @!P1 BRA 0x10 ;
        /*00e0*/                   EXIT ;
        /*00f0*/                   BRA 0x10 ;
                Function : _Z6kernelILi1EEvv
        /*0000*/                   EXIT ;
"""


def _insns():
    funcs = C.functions(LISTING)
    assert sorted(funcs) == ["_Z6kernelILi0EEvv", "_Z6kernelILi1EEvv"]
    return funcs["_Z6kernelILi0EEvv"]


def test_the_loop_is_found():
    """The conditional branch back is the loop; the unconditional one
    after the exit returns from out-of-line code and is none."""
    insns = _insns()
    assert C.loops(insns) == [(0x10, 0xd0)]
    assert C.outermost(insns, "MUFU.RSQ") == (0x10, 0xd0)


def test_the_fast_path_skips_the_call():
    insns = _insns()
    path = [a for a, _, _, _ in C.walk(insns, 0x10, 0xd0)]
    assert path == [0x10, 0x20, 0x30, 0x40, 0x50, 0x90, 0xa0, 0xb0, 0xc0]


@pytest.mark.parametrize("op, ready", [
    (0x10, 20),          # LDS
    (0x20, 34),          # MUFU after its shared load
    (0x30, 38),
    (0x40, 42),          # FCHK sets a predicate
    (0x90, 42),          # the fast path's value, not the call's
    (0xa0, 46),          # a predicated write waits for its old value
    (0xc0, 4)])          # independent of the chain
def test_latencies_add_along_dependences(op, ready):
    insns = _insns()
    cycles, times = C.chain(C.walk(insns, 0x10, 0xd0))
    assert cycles == 46
    assert dict((a, t) for a, _, t in times)[op] == ready


NESTED = """
                Function : _Z6kernelILi0EEvv
        /*0000*/                   LDS R2, [R3] ;
        /*0010*/              @!P3 BRA 0x80 ;
        /*0020*/                   FADD R4, R2, R2 ;
        /*0030*/              @!P4 BRA 0x60 ;
        /*0040*/                   FMUL R5, R4, 1.26765060022822940150e+30 ;
        /*0050*/                   FADD R4, R5, R5 ;
        /*0060*/                   FADD R6, R4, R4 ;
        /*0070*/                   STG.E desc[UR4][R8.64], R6 ;
        /*0080*/                   ISETP.GE.AND P1, PT, R9, 0x10, PT ;
        /*0090*/              @!P1 BRA 0x0 ;
        /*00a0*/                   EXIT ;
"""


@pytest.mark.parametrize("rare, path, cycles", [
    (None, [0x0, 0x10, 0x20, 0x30, 0x40, 0x50, 0x60, 0x70, 0x80], 36),
    ("1.2676506002282294", [0x0, 0x10, 0x20, 0x30, 0x60, 0x70, 0x80], 28)])
def test_the_rare_path_is_skipped(rare, path, cycles):
    """With `rare`, the innermost branch around the marked instruction is
    taken (K7's div_small inline); the branch around the whole step is
    not."""
    insns = C.functions(NESTED)["_Z6kernelILi0EEvv"]
    assert C.loops(insns) == [(0x0, 0x90)]
    walked = C.walk(insns, 0x0, 0x90, rare)
    assert [a for a, _, _, _ in walked] == path
    assert C.chain(walked)[0] == cycles
