"""tools/sass_loops.py on a hand-written SASS listing: the natural loop, its
plain and drawing paths, and the blocks it leaves out of them."""
import importlib.util
from pathlib import Path

import pytest

_TOOL = Path(__file__).resolve().parents[1] / "tools" / "sass_loops.py"
_SPEC = importlib.util.spec_from_file_location("sass_loops", _TOOL)
sass_loops = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(sass_loops)

# entry; a loop whose head branches to a hashing block or a plain one, then
# to an optional shuffle (resampling) block, then back to the head
LISTING = """
	code for sm_90a
		Function : _Z9pf_kernelv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   MOV R2, RZ ;
        /*0020*/                   ISETP.GE.AND P0, PT, R2, 0x3, PT ;
        /*0030*/              @P0 BRA 0x60 ;
        /*0040*/                   FADD R4, R4, 1 ;
        /*0050*/                   BRA 0x90 ;
        /*0060*/                   IMAD R3, R3, -0x7a143595, RZ ;
        /*0070*/                   IMAD R3, R3, -0x3d4d51cb, RZ ;
        /*0080*/                   FMUL R4, R4, R3 ;
        /*0090*/                   ISETP.NE.AND P1, PT, R5, RZ, PT ;
        /*00a0*/              @P1 BRA 0xd0 ;
        /*00b0*/                   SHFL.BFLY PT, R6, R4, 0x1, 0x1f ;
        /*00c0*/                   FADD R4, R4, R6 ;
        /*00d0*/                   IADD3 R2, R2, 0x1, RZ ;
        /*00e0*/                   ISETP.GE.AND P2, PT, R2, 0x40, PT ;
        /*00f0*/              @!P2 BRA 0x20 ;
        /*0100*/                   EXIT ;
		Function : _Z5otherv
        /*0000*/                   EXIT ;
"""


@pytest.fixture
def listing(tmp_path):
    path = tmp_path / "k.sass"
    path.write_text(LISTING)
    return path


def test_cfg_and_natural_loop(listing):
    insns = sass_loops.functions(listing.read_text())["_Z9pf_kernelv"]
    blocks, succ = sass_loops.cfg(insns)
    assert sorted(blocks) == [0x0, 0x20, 0x40, 0x60, 0x90, 0xb0, 0xd0, 0x100]
    assert sorted(succ[0x20]) == [0x40, 0x60] and succ[0x40] == [0x90]
    loops = sass_loops.natural_loops(0x0, succ)
    assert list(loops) == [0x20]
    body, latches = loops[0x20]
    assert body == {0x20, 0x40, 0x60, 0x90, 0xb0, 0xd0} and latches == {0xd0}


def test_plain_and_draw_paths_skip_the_resampling(listing, capsys):
    """plain: head, plain arm, join, latch (2 + 2 + 2 + 3); draw: through
    the hashing block instead (2 + 3 + 2 + 3); the shuffle block is on
    neither."""
    sass_loops.report(str(listing), "pf_kernel", show_blocks=True)
    out = capsys.readouterr().out
    assert "_Z9pf_kernelv: 17 instructions, 8 blocks, 1 loops" in out
    assert "step loop at 0x0020: 6 blocks, 14 instructions" in out
    assert "plain 9, draw 10 instructions" in out
    assert "block 0x00b0:    2 instructions -> 0x00d0  resample" in out
    assert "_Z5otherv" not in out
