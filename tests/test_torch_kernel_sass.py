"""``repro_torch.launch.kernel_sass`` reads a ``cuobjdump -sass`` listing:
its functions, opcode counts and innermost loops, on a listing written
here (the CUDA toolkit exists only on the card's machine)."""
from repro_torch.launch.kernel_sass import functions, histogram, loops

LISTING = """\
\tcode for sm_90a
\t\tFunction : _ZN1a11wkv6_kernelIfLi64EEEv
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;              /* 0x0000000000007919 */
        /*0020*/                   LDS.128 R4, [R2] ;              /* 0x0000000002047984 */
        /*0030*/                   FFMA R5, R4, R5, R6 ;           /* 0x0000000504057223 */
        /*0040*/              @!P0 BRA 0x20 ;                      /* 0x0000000000f48947 */
        /*0050*/                   SHFL.BFLY PT, R8, R5, 0x4, 0x1f ; /* 0x0c801f0005087f89 */
        /*0060*/               @P1 BRA 0x10 ;                      /* 0x0000000000e41947 */
        /*0070*/                   EXIT ;                          /* 0x000000000000794d */
        /*0080*/                   BRA 0x80;                       /* 0xfffffffc00fc7947 */
\t\tFunction : _ZN1a13negate_kernelIfEEvPKT_PS1_xxi
        /*0000*/                   EXIT ;                          /* 0x000000000000794d */
"""


def test_functions_opcodes_and_innermost_loops():
    fns = functions(LISTING)
    assert list(fns) == ["_ZN1a11wkv6_kernelIfLi64EEEv", "_ZN1a13negate_kernelIfEEvPKT_PS1_xxi"]
    wkv = fns["_ZN1a11wkv6_kernelIfLi64EEEv"]
    assert [op for _, op, _ in wkv] == ["LDC", "S2R", "LDS.128", "FFMA", "BRA", "SHFL.BFLY",
                                        "BRA", "EXIT", "BRA"]
    assert histogram(wkv).startswith("BRA 3, ")
    # 0x20-0x40 nests inside 0x10-0x60, so only it is innermost; 0x80 -> 0x80 is no loop
    assert loops(wkv) == [(2, 4)]
