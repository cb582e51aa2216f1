"""The SASS reader behind the instruction-count bounds (``sass.py``), on a
small hand-written ``cuobjdump -sass`` listing: functions and labels,
the fast-path walk, the pipe classes, and the least issue time."""
import os
import re

import pytest

from gravinv3dhmc_tpu_torch import sass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# two kernels of an anonymous namespace, in cuobjdump's layout: each
# instruction line followed by its encoding's second half
LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_115gz_nodes_kernelEPKf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   EXIT ;                      /* 0x000000000000794d */
\t\t..........


\t\tFunction : _ZN12_GLOBAL__N_19gz_kernelEPKfS1_Pfiif
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   IMAD.MOV.U32 R2, RZ, RZ, c[0x0][0x210] ;
        /*0020*/                   IMAD.U32 R3, RZ, RZ, UR4 ;
        /*0030*/                   IMAD.WIDE.U32 R4, R2, -0x326172a9, RZ ;
        /*0040*/                   FSETP.GEU.AND P0, PT, R4, RZ, PT ;
        /*0050*/              @!P0 BRA `(.L_x_1) ;
        /*0060*/                   DMUL R6, R4, R4 ;
        /*0070*/                   CALL.REL.NOINC `(.L_x_5) ;
.L_x_1:
        /*0080*/                   MUFU.RSQ R7, R4 ;
        /*0090*/                   FFMA R8, R7, R7, R4 ;
        /*00a0*/               @P0 EXIT ;
        /*00b0*/                   NOP ;
        /*00c0*/                   FADD R8, R8, 1 ;
        /*00d0*/                   I2FP.F32.U32 R9, R3 ;
        /*00e0*/                   BRA `(.L_x_2) ;
        /*00f0*/                   FMUL R9, R9, R9 ;
.L_x_2:
        /*0100*/                   MUFU.RSQ R10, R9 ;
        /*0110*/                   LOP3.LUT R11, R10, R9, RZ, 0x3c, !PT ;
        /*0120*/                   EXIT ;
.L_x_5:
        /*0130*/                   RET.REL.NODEC R20 `(_ZN12_GLOBAL__N_19gz_kernelEPKfS1_Pfiif) ;
"""

#: the fast path through gz_kernel above: the forward branch over the
#: region with DMUL and CALL (no MUFU.RSQ) taken, the predicated EXIT
#: passed, the NOP left out, the unconditional BRA followed past FMUL
FAST = ["LDC", "IMAD", "IMAD", "IMAD", "FSETP", "BRA", "MUFU", "FFMA",
        "EXIT", "FADD", "I2FP", "BRA", "MUFU", "LOP3", "EXIT"]


def test_parse_splits_functions_and_labels():
    fns = sass.parse(LISTING)
    assert len(fns) == 2
    instrs, labels = sass.find(fns, "gz_kernel")
    assert len(instrs) == 19                    # the NOP left out
    assert labels == {".L_x_1": 0x80, ".L_x_2": 0x100, ".L_x_5": 0x130}
    assert instrs[5] == (0x50, "@!P0", "BRA", "", "`(.L_x_1)")
    assert instrs[1][2:4] == ("IMAD", ".MOV.U32")
    assert len(sass.find(fns, "gz_nodes_kernel")[0]) == 2


@pytest.mark.parametrize("name", ["draws_kernel", "kernel", "nodes_kernel"])
def test_find_needs_the_whole_name(name):
    with pytest.raises(KeyError):
        sass.find(sass.parse(LISTING), name)


@pytest.mark.parametrize("skip_slow,extra", [(True, []),
                                              (False, ["DMUL", "CALL"])])
def test_path_skips_only_slow_regions(skip_slow, extra):
    steps = sass.path(*sass.find(sass.parse(LISTING), "gz_kernel"), skip_slow)
    want = FAST[:6] + extra + FAST[6:]
    assert [op for op, _, _ in steps] == want


def test_counts_classes_and_moves():
    steps = sass.path(*sass.find(sass.parse(LISTING), "gz_kernel"), True)
    # IMAD.MOV and IMAD RZ * RZ + x are moves; IMAD.WIDE is a multiply-add
    assert sass.counts(steps) == {
        "BRA": 2, "EXIT": 2, "LDC": 1, "MOV": 2, "alu": 2, "fma": 2,
        "imad": 1, "mufu_conv": 3}
    assert sass.counts(steps, per=2)["mufu_conv"] == 1.5
    segs = sass.corner_segments(steps)
    assert [[op for op, _, _ in seg] for seg in segs] == [
        ["MUFU", "FFMA", "EXIT", "FADD", "I2FP", "BRA"]]


#: a rolled loop, one unit of work a pass: the setup before it, a slow
#: path (the CALL) skipped inside it, its back edge at 0xb0
LOOP = """
\t\tFunction : _ZN12_GLOBAL__N_121momentum4_loop_kernelEP6float4PKiijjj
        /*0000*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0010*/                   IADD3 R6, R2, 0x1, RZ ;
        /*0020*/                   ISETP.GE.AND P0, PT, R2, R3, PT ;
        /*0030*/               @P0 EXIT ;
.L_x_0:
        /*0040*/                   IMAD.WIDE.U32 R4, R2, -0x326172a9, RZ ;
        /*0050*/                   FSETP.GEU.AND P1, PT, R4, RZ, PT ;
        /*0060*/              @!P1 BRA `(.L_x_1) ;
        /*0070*/                   CALL.REL.NOINC `(.L_x_2) ;
.L_x_1:
        /*0080*/                   MUFU.LG2 R5, R4 ;
        /*0090*/                   VIADD R2, R2, 0x1 ;
        /*00a0*/                   ISETP.GE.AND P0, PT, R2, R3, PT ;
        /*00b0*/              @!P0 BRA `(.L_x_0) ;
        /*00c0*/                   EXIT ;
.L_x_2:
        /*00d0*/                   RET.REL.NODEC R20 `(_Z1f) ;
\t\tFunction : _ZN12_GLOBAL__N_126accept_uniform_once_kernelEPfijjj
        /*0000*/                   I2FP.F32.U32 R9, R3 ;
        /*0010*/                   EXIT ;
"""


def test_loop_pass_walks_one_pass():
    fns = sass.parse(LOOP)
    steps = sass.loop_pass(*sass.find(fns, "momentum4_loop_kernel"))
    assert [op for op, _, _ in steps] == [
        "IMAD", "FSETP", "BRA", "MUFU", "VIADD", "ISETP", "BRA"]
    with pytest.raises(KeyError):
        sass.loop_pass(*sass.find(sass.parse(LISTING), "gz_kernel"))


def test_unit_counts_from_the_listings(monkeypatch):
    monkeypatch.setattr(sass, "functions",
                        lambda lib: (lib, sass.parse(lib)))
    units = sass.unit_counts(LOOP, LISTING)
    assert units["normal4"] == {"BRA": 2, "alu": 3, "imad": 1,
                                "mufu_conv": 1}
    assert units["uniform"] == {"EXIT": 1, "mufu_conv": 1}
    # gz_kernel's one corner term (fall-through) less the corner sum's FADD
    assert units["node"] == {"BRA": 1, "EXIT": 1, "fma": 1, "mufu_conv": 2}


@pytest.mark.parametrize("source,kernels", [
    ("leapfrog.cu", ("momentum4_loop_kernel", "accept_uniform_once_kernel")),
    ("prism_gz.cu", ("gz_kernel",))])
def test_counted_kernels_exist(source, kernels):
    text = open(os.path.join(REPO, "gravinv3dhmc_tpu_torch", "csrc",
                             source)).read()
    for name in kernels:
        assert re.search(rf"__global__ void(?: __launch_bounds__\(\w+\))?"
                         rf"\s+{name}\(", text), name


def test_scaled_sums_units_and_keeps_arithmetic():
    got = sass.scaled(({"fma": 2, "MOV": 5}, 10), ({"fma": 1, "alu": 3}, 2),
                      fma=4)
    assert got == {"fma": 26, "alu": 6}


@pytest.mark.parametrize("counts,seconds", [
    ({"fma": 256}, 2.0),                       # the FMA pipes
    ({"imad": 32}, 0.5),                       # one FMA pipe
    ({"alu": 64, "fma": 32}, 1.0),             # the ALU
    ({"mufu_conv": 16, "fma": 64}, 1.0),       # MUFU
    ({"fma": 100, "alu": 60, "imad": 36}, 1.53125),   # issue: 196 / 128
    ({"MOV": 1000, "BRA": 99, "fma": 128}, 1.0)])     # moves left out
def test_instruction_seconds_takes_the_slowest_pipe(counts, seconds):
    """Counts in lanes of a second of the whole card: the time is the
    slowest of the issue and each pipe."""
    lanes = sass.SMS * sass.CLOCK_HZ
    got = sass.instruction_seconds({k: v * lanes for k, v in counts.items()})
    assert got == pytest.approx(seconds)
