"""``tools.sass_diff``'s comparison, on the CPU: the compile and disassembly
step (``sass``) is replaced by fixed function tables, so what is checked is
how OLD's functions are matched against several NEW sources, ``--moved`` and
``--rename``, and the exit status."""

import pytest

from text_to_sound_synthesis_torch.tools import sass_diff as sd

OLD = {"kA": ["MOV", "EXIT"], "kB": ["IADD", "EXIT"], "kC": ["FADD", "EXIT"],
       "gemmILi2EE": ["HMMA", "EXIT"]}
# OLD's functions split over two files: kA unchanged in the first, kB in the
# second, kC's code changed, gemmILi2EE moved onto a new kernel
NEW = {"a.cu": {"kA": ["MOV", "EXIT"], "sm90ILi2EE": ["WGMMA", "EXIT"]},
       "b.cu": {"kB": ["IADD", "EXIT"], "kC": ["FMUL", "EXIT"]}}


@pytest.fixture
def tables(monkeypatch):
    monkeypatch.setattr(sd, "sass", lambda source, out_dir: dict(
        OLD if source == "old.cu" else NEW[source]))


def test_compare_pools_sources_and_expected_moves():
    new = {**NEW["a.cu"], **NEW["b.cu"]}
    same, differ, moved, lost, added = sd.compare(OLD, new, [r"gemmILi\d+EE"])
    assert same == ["kA", "kB"] and differ == ["kC"]
    assert moved == ["gemmILi2EE"] and lost == [] and added == ["sm90ILi2EE"]
    # without --moved the same function is lost; a pattern must match the whole name
    assert sd.compare(OLD, new)[3] == ["gemmILi2EE"]
    assert sd.compare(OLD, new, ["gemm"])[3] == ["gemmILi2EE"]


@pytest.mark.parametrize("argv, shown", [
    (["old.cu", "--new", "a.cu", "b.cu", "--moved", "gemm.*"], True),                 # kC differs
    (["old.cu", "--new", "a.cu", "b.cu", "--moved", "gemm.*", "--rename", "kC", "kX"], False),  # kX gone
    (["old.cu", "--new", "a.cu", "b.cu", "--moved", "gemm.*", "--moved", "kC"], True),  # kC present, differs
])
def test_main_exit_status(tables, capsys, argv, shown):
    """Nonzero when an OLD function differs or is gone unexpectedly; where a
    function differs, the lines where it parts are printed."""
    assert sd.main(argv) == 1
    out = capsys.readouterr().out
    assert "identical SASS 2" in out
    assert ("kC: 2 lines in OLD, 2 in NEW; first difference at line 0" in out) == shown


def test_main_passes_when_only_expected_functions_are_gone(tables, monkeypatch, capsys):
    old = {k: v for k, v in OLD.items() if k != "kC"}
    monkeypatch.setattr(sd, "sass", lambda source, out_dir: dict(
        old if source == "old.cu" else NEW[source]))
    assert sd.main(["old.cu", "--new", "a.cu", "b.cu", "--moved", r"gemmILi\d+EE"]) == 0
    assert "gone, moved as expected (1): ['gemmILi2EE']" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        sd.main(["old.cu"])            # no NEW source


def test_parse_leaves_out_addresses_namespace_tag_and_header_flags():
    """Two listings of one kernel from files whose ELF flags and column
    padding differ (one holds kernels with sm_90a-only instructions, longer
    lines): the same function."""
    def listing(tag, flags):
        return (f"\tcode for sm_90a\n\t\tFunction : _ZN46_GLOBAL__N__{tag}_13_int8_block_cu_{tag}"
                f"4kernEv\n\t.headerflags\t@\"{flags}\"\n"
                "        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */\n"
                "        /*0010*/                   EXIT ;                   /* 0x000000000000794d */\n")
    a = sd.parse(listing("5f1bee63", "EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"))
    b = sd.parse(listing("8bdb6125", "EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90) EF_X")
                 .replace(" ;   ", " ;            "))   # the other file's column padding
    assert list(a) == ["_ZN46ANON4kernEv"] and a == b
    assert a["_ZN46ANON4kernEv"][0].startswith("LDC R1")


def test_count_prints_each_new_functions_matching_instructions(tables, capsys):
    """``--count``: per NEW function, its instructions matching each expression
    (e.g. CALL, which makes ptxas serialize a kernel's wgmma)."""
    assert sd.counts({"k": ["CALL.REL 0x10", "WGMMA", "EXIT", "CALL.ABS"]}, ["CALL", "MMA"]) == \
        {"k": [2, 1]}
    assert sd.main(["old.cu", "--new", "a.cu", "b.cu", "--moved", ".*", "--count", "WGMMA",
                    "--count", "EXIT"]) == 1   # kC still differs
    out = capsys.readouterr().out
    assert "sm90ILi2EE: WGMMA 1, EXIT 1" in out and "kA: WGMMA 0, EXIT 1" in out
