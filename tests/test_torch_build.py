"""The port's kernel build, on the CPU: per-source nvcc flags, and library
names that change with the flags, the source or any header beside it, so
that a stale library in build/ is never loaded.  A stand-in for nvcc records
the commands ``build`` runs."""

import ctypes
import re
import stat
import sys

import pytest

from repro_torch import kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ of two sources and a header, a build/ and a recording nvcc."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "toy_kernels.cu").write_text('#include "toy.cuh"\n')
    (src / "other_kernels.cu").write_text("// no header\n")
    (src / "toy.cuh").write_text("// v1\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "open(args[args.index('-o') + 1], 'w').write(' '.join(args))\n"
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kernels, "CSRC", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    return src


def test_name_is_stable_and_names_the_source(csrc):
    path = kernels.library_path(csrc / "toy_kernels.cu")
    assert path == kernels.library_path(csrc / "toy_kernels.cu")
    assert path.parent == kernels.BUILD_DIR and path.name.startswith("libtoy_kernels_")


def test_header_change_renames_the_library(csrc):
    before = kernels.library_path(csrc / "toy_kernels.cu")
    (csrc / "toy.cuh").write_text("// v2\n")
    assert kernels.library_path(csrc / "toy_kernels.cu") != before
    (csrc / "toy.cuh").write_text("// v1\n")
    assert kernels.library_path(csrc / "toy_kernels.cu") == before
    (csrc / "new.cuh").write_text("// a header more\n")
    assert kernels.library_path(csrc / "toy_kernels.cu") != before


def test_source_change_renames_the_library(csrc):
    before = kernels.library_path(csrc / "toy_kernels.cu")
    (csrc / "toy_kernels.cu").write_text('#include "toy.cuh"\n// edited\n')
    assert kernels.library_path(csrc / "toy_kernels.cu") != before


def test_flag_change_renames_the_library(csrc, monkeypatch):
    before = kernels.library_path(csrc / "toy_kernels.cu")
    other = kernels.library_path(csrc / "other_kernels.cu")
    monkeypatch.setitem(kernels._SOURCE_FLAGS, "toy_kernels", kernels._FLAGS + ["-DTOY"])
    assert kernels.library_path(csrc / "toy_kernels.cu") != before
    assert kernels.library_path(csrc / "other_kernels.cu") == other


def test_attention_fuses_and_the_other_sources_do_not():
    flags = {stem: kernels.compile_flags(stem) for stem in kernels.sources()}
    assert set(flags) == {"attention_kernels", "block_kernels", "delta_kernels",
                          "segment_kernels"}
    for stem, f in flags.items():
        assert f[:2] == ["-gencode", "arch=compute_90a,code=sm_90a"], stem
        assert ("-fmad=false" in f) == (stem != "attention_kernels"), stem
    assert [x for x in flags["segment_kernels"] if x != "-fmad=false"] == \
        flags["attention_kernels"]


def test_build_runs_each_sources_own_command_once(csrc, monkeypatch):
    monkeypatch.setitem(kernels._SOURCE_FLAGS, "toy_kernels", kernels._FLAGS + ["-DTOY"])
    paths = kernels.build()
    assert set(paths) == {"toy_kernels", "other_kernels"}
    for stem, path in paths.items():
        args = path.read_text().split()
        assert args[:-3] == kernels.compile_flags(stem)
        assert args[-1] == str(csrc / f"{stem}.cu")
        assert path.with_suffix(".log").exists()
    assert "-DTOY" in paths["toy_kernels"].read_text()
    assert "-DTOY" not in paths["other_kernels"].read_text()
    stamp = {stem: p.stat().st_mtime_ns for stem, p in paths.items()}
    assert kernels.build() == paths  # built libraries are not rebuilt
    assert {stem: p.stat().st_mtime_ns for stem, p in paths.items()} == stamp
    (csrc / "toy.cuh").write_text("// v2\n")
    again = kernels.build()
    assert again["toy_kernels"] != paths["toy_kernels"] and again["toy_kernels"].exists()
    assert again["other_kernels"] != paths["other_kernels"]  # every header counts


_C_TYPES = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
            "int": ctypes.c_int, "float": ctypes.c_float}


def test_entries_match_their_c_signatures():
    """Every entry of the load table is defined in its source, with one
    argtype of the right width for each C parameter (a pointer or a long
    long passed as a 32-bit int would be cut)."""
    for stem, (err_fn, entries) in kernels._ENTRIES.items():
        src = (kernels.CSRC / f"{stem}.cu").read_text()
        assert re.search(rf"const char\* {err_fn}\(int err\)", src), err_fn
        for entry, argtypes in entries.items():
            m = re.search(rf"\nint {entry}\(([^)]*)\)", src)
            assert m, f"{stem}: no entry {entry}"
            params = [" ".join(p.split()) for p in m.group(1).split(",")]
            kinds = [next(c for t, c in _C_TYPES.items()
                          if p.replace("const ", "").startswith(t)) for p in params]
            assert kinds == list(argtypes), entry


def test_segment_library_runs_the_solver_loops():
    """The Prim / MP loop kernels are loaded, and the one-thread re-parenting
    step they replaced is gone from the table and the source."""
    entries = kernels._ENTRIES["segment_kernels"][1]
    assert {"segment_prim_loop", "segment_mp_loop", "segment_loop_floor"} <= set(entries)
    assert "segment_mp_reparent" not in entries
    src = (kernels.CSRC / "segment_kernels.cu").read_text()
    assert "mp_reparent" not in src
    assert kernels.library_path(kernels.sources()["segment_kernels"]).name.startswith(
        "libsegment_kernels_")


def _c_body(src: str, entry: str) -> str:
    return re.search(rf"\nint {entry}\(.*?\n}}\n", src, re.S).group(0)


def test_segment_reductions_pin_their_c_signatures():
    """The row reductions take (x, out, rows, width); the 1d reduction takes
    the caller's per-stream workspace and its size, and no scratch buffers;
    the launch floor takes nothing but the device and the stream."""
    _i, _ll, _vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    entries = kernels._ENTRIES["segment_kernels"][1]
    assert entries["segment_min_rows"] == [_i, _vp, _vp, _ll, _ll, _vp]
    assert entries["segment_argmin_rows"] == [_i, _vp, _vp, _ll, _ll, _vp]
    # device; x, out_val, out_idx, workspace; n, workspace bytes; stream
    assert entries["segment_min_argmin_1d"] == [_i, _vp, _vp, _vp, _vp, _ll, _ll, _vp]
    assert entries["segment_launch_floor"] == [_i, _vp]


def test_segment_reductions_are_one_template_and_one_1d_launch():
    """The min and the argmin over rows are one kernel template with two
    bodies; min_argmin_1d is one launch a call (the two-stage parts and
    final kernels are gone); the library keeps -fmad=false."""
    src = (kernels.CSRC / "segment_kernels.cu").read_text()
    assert "-fmad=false" in kernels.compile_flags("segment_kernels")
    assert "argmin_final_kernel" not in src and "argmin_parts_kernel" not in src
    assert "min_rows_kernel" not in src and "argmin_rows_kernel" not in src
    assert src.count("rows_kernel<Op><<<") == 1
    assert "launch_rows<MinOp>" in _c_body(src, "segment_min_rows")
    assert "launch_rows<ArgminOp>" in _c_body(src, "segment_argmin_rows")
    one_d = _c_body(src, "segment_min_argmin_1d")
    assert one_d.count("<<<") == 1 and "argmin_1d_kernel<<<" in one_d
    assert "cudaMalloc" not in src and "cudaMemset" not in src
