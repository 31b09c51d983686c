"""MPS reader tests: demo file, sections, RANGES/BOUNDS semantics,
gzip, and quirk handling (golden semantics from reference
src/mps_reader.cpp; see hprlp_tpu/io/mps.py docstring)."""

import gzip
import math
import os
import textwrap

import numpy as np
import pytest

from hprlp_tpu.io.mps import MpsFormatError, read_mps

DEMO_MPS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "data", "model.mps")


def _write(tmp_path, text, name="t.mps"):
    p = os.path.join(tmp_path, name)
    with open(p, "w") as f:
        f.write(textwrap.dedent(text))
    return p


def test_demo_file():
    p = read_mps(DEMO_MPS)
    assert p.m == 2 and p.n == 2 and p.nnz == 4
    np.testing.assert_allclose(p.A.toarray(), [[1, 2], [3, 1]])
    np.testing.assert_allclose(p.AU, [10, 12])
    assert np.all(np.isinf(p.AL)) and np.all(p.AL < 0)
    np.testing.assert_allclose(p.c, [-3, -5])
    np.testing.assert_allclose(p.l, [0, 0])
    assert np.all(np.isinf(p.u))


def test_demo_file_gzip(tmp_path):
    gz = os.path.join(tmp_path, "model.mps.gz")
    with open(DEMO_MPS, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    p = read_mps(gz)
    assert p.m == 2 and p.nnz == 4


def test_row_types_and_rhs(tmp_path):
    p = read_mps(_write(tmp_path, """\
        NAME test
        ROWS
         N  obj
         E  r1
         G  r2
         L  r3
        COLUMNS
            x  obj  1.0  r1  1.0
            x  r2   2.0  r3  3.0
        RHS
            rhs  r1  5.0  r2  4.0
            rhs  r3  9.0
        ENDATA
        """))
    np.testing.assert_allclose(p.AL, [5.0, 4.0, -np.inf])
    np.testing.assert_allclose(p.AU, [5.0, np.inf, 9.0])


def test_rhs_on_objective_sets_constant(tmp_path):
    # reference: mps_reader.cpp:767  c0 = -val
    p = read_mps(_write(tmp_path, """\
        ROWS
         N  obj
         G  r1
        COLUMNS
            x  obj  1.0  r1  1.0
        RHS
            rhs  obj  7.0  r1  1.0
        ENDATA
        """))
    assert p.obj_constant == -7.0


def test_ranges_semantics(tmp_path):
    # reference: mps_reader.cpp:813-836
    p = read_mps(_write(tmp_path, """\
        ROWS
         N  obj
         E  e1
         E  e2
         L  l1
         G  g1
        COLUMNS
            x  obj  1.0  e1  1.0
            x  e2   1.0  l1  1.0
            x  g1   1.0
        RHS
            rhs  e1  1.0  e2  1.0
            rhs  l1  8.0  g1  3.0
        RANGES
            rng  e1  2.0   e2  -2.0
            rng  l1  4.0   g1  -5.0
        ENDATA
        """))
    np.testing.assert_allclose(p.AL, [1.0, -1.0, 4.0, 3.0])
    np.testing.assert_allclose(p.AU, [3.0, 1.0, 8.0, 8.0])


def test_bounds_cards(tmp_path):
    p = read_mps(_write(tmp_path, """\
        ROWS
         N  obj
         G  r
        COLUMNS
            a  obj  1.0  r  1.0
            b  obj  1.0  r  1.0
            c  obj  1.0  r  1.0
            d  obj  1.0  r  1.0
            e  obj  1.0  r  1.0
            f  obj  1.0  r  1.0
            g  obj  1.0  r  1.0
        RHS
            rhs  r  1.0
        BOUNDS
         FR bnd  a
         MI bnd  b
         UP bnd  c  4.0
         LO bnd  d  -2.0
         FX bnd  e  3.0
         BV bnd  f
         UP bnd  g  -1.0
        ENDATA
        """))
    l, u = p.l, p.u
    assert l[0] == -np.inf and u[0] == np.inf          # FR
    assert l[1] == -np.inf and u[1] == np.inf          # MI -> default u=inf
    assert l[2] == 0.0 and u[2] == 4.0                 # UP with u>=0 -> l=0
    assert l[3] == -2.0 and u[3] == np.inf             # LO -> default u=inf
    assert l[4] == 3.0 and u[4] == 3.0                 # FX
    assert l[5] == 0.0 and u[5] == 1.0                 # BV
    assert l[6] == -np.inf and u[6] == -1.0            # UP with u<0 -> l=-inf


def test_default_bounds(tmp_path):
    p = read_mps(_write(tmp_path, """\
        ROWS
         N  obj
         G  r
        COLUMNS
            x  obj  1.0  r  1.0
        RHS
        ENDATA
        """))
    assert p.l[0] == 0.0 and p.u[0] == np.inf
    # G row with no RHS defaults to [0, inf) (reference: :649-650)
    assert p.AL[0] == 0.0 and p.AU[0] == np.inf


def test_objsense_max_applied(tmp_path):
    # Deliberate fix of reference quirk: OBJSENSE MAX is applied.
    p = read_mps(_write(tmp_path, """\
        OBJSENSE
            MAX
        ROWS
         N  obj
         L  r
        COLUMNS
            x  obj  2.0  r  1.0
        RHS
            rhs  r  5.0
        ENDATA
        """))
    assert p.objective_sense == -1
    np.testing.assert_allclose(p.c, [-2.0])


def test_quadobj_rejected(tmp_path):
    txt = """\
        ROWS
         N  obj
         G  r
        COLUMNS
            x  obj  1.0  r  1.0
        QUADOBJ
            x  x  2.0
        ENDATA
        """
    with pytest.raises(MpsFormatError):
        read_mps(_write(tmp_path, txt))
    p = read_mps(_write(tmp_path, txt), ignore_quadobj=True)
    assert p.n == 1


def test_duplicate_entries_summed(tmp_path):
    # reference: coo_to_csr sums duplicates (mps_reader.cpp:1266-1361)
    p = read_mps(_write(tmp_path, """\
        ROWS
         N  obj
         G  r
        COLUMNS
            x  r  1.0
            x  r  2.5
        RHS
        ENDATA
        """))
    assert p.nnz == 1
    assert p.A[0, 0] == 3.5


def test_markers_and_comments(tmp_path):
    p = read_mps(_write(tmp_path, """\
        * a comment
        ROWS
         N  obj
         G  r
        COLUMNS
            MARK0  'MARKER'  'INTORG'
            x  r  1.0
            MARK1  'MARKER'  'INTEND'
            y  r  1.0
        RHS
            rhs  r  1.0
        ENDATA
        """))
    assert p.n == 2 and p.m == 1


def test_rim_objective_ignored(tmp_path):
    p = read_mps(_write(tmp_path, """\
        ROWS
         N  obj
         N  obj2
         G  r
        COLUMNS
            x  obj  1.0  obj2  99.0
            x  r  1.0
        RHS
        ENDATA
        """))
    assert p.m == 1 and p.nnz == 1
    np.testing.assert_allclose(p.c, [1.0])


def test_solve_demo_mps():
    import hprlp_tpu as h
    from hprlp_tpu.params import Parameters
    res = h.solve_mps(DEMO_MPS, Parameters(verbose=False, precision="f64"))
    assert res.status == "OPTIMAL"
    assert abs(res.primal_obj - (-26.4)) < 2e-2


# ---------------------------------------------------------------------------
# Fixed-format MPS (column-position cards; spaces allowed inside names).
# Reference: read_card_fixed, src/mps_reader.cpp:360-483.
# ---------------------------------------------------------------------------

def _fixed_card(f1="", f2="", f3="", f4="", f5="", f6=""):
    """Place fields at the fixed-format columns (1-based): f1 2-3, f2 5-12,
    f3 15-22, f4 25-36, f5 40-47, f6 50-61."""
    line = [" "] * 61
    for s, start, width in ((f1, 1, 2), (f2, 4, 8), (f3, 14, 8),
                            (f4, 24, 12), (f5, 39, 8), (f6, 49, 12)):
        s = str(s)
        assert len(s) <= width, (s, width)
        line[start:start + len(s)] = s
    return "".join(line).rstrip()


def _write_fixed_demo(tmp_path):
    """The 2x2 demo LP with spaces inside every name."""
    lines = [
        "NAME          SPACE MODEL",
        "ROWS",
        _fixed_card("N", "THE OBJ"),
        _fixed_card("L", "ROW A"),
        _fixed_card("L", "ROW B"),
        "COLUMNS",
        _fixed_card("", "X ONE", "THE OBJ", "-3.0", "ROW A", "1.0"),
        _fixed_card("", "X ONE", "ROW B", "3.0"),
        _fixed_card("", "X TWO", "THE OBJ", "-5.0", "ROW A", "2.0"),
        _fixed_card("", "X TWO", "ROW B", "1.0"),
        "RHS",
        _fixed_card("", "MY RHS", "ROW A", "10.0", "ROW B", "12.0"),
        "BOUNDS",
        _fixed_card("LO", "BND SET", "X ONE", "0.0"),
        _fixed_card("LO", "BND SET", "X TWO", "0.0"),
        "ENDATA",
    ]
    p = os.path.join(tmp_path, "fixed.mps")
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    return p


def test_fixed_format_python_reader(tmp_path):
    p = read_mps(_write_fixed_demo(tmp_path), mps_format="fixed")
    assert p.name == "SPACE MODEL"
    assert p.m == 2 and p.n == 2 and p.nnz == 4
    np.testing.assert_allclose(p.A.toarray(), [[1, 2], [3, 1]])
    np.testing.assert_allclose(p.AU, [10, 12])
    np.testing.assert_allclose(p.c, [-3, -5])
    np.testing.assert_allclose(p.l, [0, 0])


def test_fixed_format_free_parse_differs(tmp_path):
    # The same file free-parsed splits "THE OBJ" into two tokens — the
    # free parse must either error out or produce a different model
    # (this is why fixed mode exists).
    path = _write_fixed_demo(tmp_path)
    try:
        free = read_mps(path)
    except ValueError:
        return
    assert free.nnz != 4 or free.m != 2


def test_fixed_format_native_reader(tmp_path):
    from hprlp_tpu.io.native_mps import is_available, read_mps_native
    if not is_available():
        pytest.skip("native library unavailable")
    path = _write_fixed_demo(tmp_path)
    a = read_mps_native(path, mps_format="fixed")
    b = read_mps(path, mps_format="fixed")
    assert a.name == b.name == "SPACE MODEL"
    assert a.m == b.m and a.n == b.n and a.nnz == b.nnz
    np.testing.assert_allclose(a.A.toarray(), b.A.toarray())
    np.testing.assert_allclose(a.AL, b.AL)
    np.testing.assert_allclose(a.AU, b.AU)
    np.testing.assert_allclose(a.l, b.l)
    np.testing.assert_allclose(a.u, b.u)
    np.testing.assert_allclose(a.c, b.c)


def test_fixed_format_demo_equivalence(tmp_path):
    # The fixed-column file _write_fixed_demo writes is the demo LP with
    # names that only fixed columns can hold: its fixed parse must agree
    # with the free parse of the demo file.
    a = read_mps(DEMO_MPS)
    b = read_mps(_write_fixed_demo(tmp_path), mps_format="fixed")
    np.testing.assert_allclose(a.A.toarray(), b.A.toarray())
    np.testing.assert_allclose(a.AU, b.AU)
    np.testing.assert_allclose(a.c, b.c)


def test_fixed_format_solves(tmp_path):
    import hprlp_tpu as h
    from hprlp_tpu.params import Parameters
    res = h.solve_mps(_write_fixed_demo(tmp_path), 
                      Parameters(verbose=False, precision="f64"),
                      mps_format="fixed")
    assert res.status == "OPTIMAL"
    assert abs(res.primal_obj - (-26.4)) < 2e-2


# --- strictness parity (round-2 review): both readers must FAIL, not ---
# --- silently diverge, on malformed input                             ---

MALFORMED_NUM = """\
NAME T
ROWS
 N OBJ
 L R1
COLUMNS
 X OBJ 1.0 R1 1.5D+2
RHS
 RH R1 4.0
ENDATA
"""

DUP_ROW = """\
NAME T
ROWS
 N OBJ
 G R1
 L R1
COLUMNS
 X OBJ 1.0 R1 2.0
RHS
 RH R1 4.0
ENDATA
"""


def test_malformed_number_raises_python(tmp_path):
    with pytest.raises(ValueError):
        read_mps(_write(tmp_path, MALFORMED_NUM))


def test_malformed_number_raises_native(tmp_path):
    from hprlp_tpu.io.native_mps import is_available, read_mps_native
    if not is_available():
        pytest.skip("native library unavailable")
    with pytest.raises(ValueError, match="bad number"):
        read_mps_native(_write(tmp_path, MALFORMED_NUM))


def test_duplicate_row_name_raises_python(tmp_path):
    with pytest.raises(MpsFormatError, match="duplicate row"):
        read_mps(_write(tmp_path, DUP_ROW))


def test_duplicate_row_name_raises_native(tmp_path):
    from hprlp_tpu.io.native_mps import is_available, read_mps_native
    if not is_available():
        pytest.skip("native library unavailable")
    with pytest.raises(ValueError, match="duplicate row"):
        read_mps_native(_write(tmp_path, DUP_ROW))


def test_truncated_gzip_raises_native(tmp_path):
    from hprlp_tpu.io.native_mps import is_available, read_mps_native
    if not is_available():
        pytest.skip("native library unavailable")
    gz = os.path.join(tmp_path, "model.mps.gz")
    with open(DEMO_MPS, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    with open(gz, "rb") as f:
        blob = f.read()
    trunc = os.path.join(tmp_path, "trunc.mps.gz")
    with open(trunc, "wb") as f:
        f.write(blob[: len(blob) // 2])  # cut mid-stream
    with pytest.raises(ValueError, match="truncated or corrupt"):
        read_mps_native(trunc)
    # Python reader also refuses it (EOFError from gzip).
    with pytest.raises((EOFError, ValueError)):
        read_mps(trunc)


def test_model_from_mps_uses_native_reader(tmp_path):
    """Model.from_mps routes through the native fast path when built and
    agrees with the Python golden reader."""
    from hprlp_tpu.io.native_mps import is_available
    from hprlp_tpu.model import Model
    if not is_available():
        pytest.skip("native library unavailable")
    m = Model.from_mps(DEMO_MPS)
    p = read_mps(DEMO_MPS)
    np.testing.assert_allclose(m.problem.A.toarray(), p.A.toarray())
    np.testing.assert_allclose(m.problem.c, p.c)


def test_readers_agree_on_generated_file(tmp_path):
    """Property cross-check: the native and Python readers parse a
    generated many-section file (ROWS/COLUMNS/RHS/BOUNDS, multi-line
    buffer splits, long names) to the same model.  Guards the native
    reader's block/line-carry machinery (lines spanning gzread block
    boundaries) against the line-at-a-time golden reader."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    "benchmarks"))
    from prof_mps_scale import write_big_mps
    from hprlp_tpu.io.native_mps import is_available, read_mps_native
    if not is_available():
        pytest.skip("native library unavailable")
    path = os.path.join(tmp_path, "gen.mps")
    write_big_mps(path, m=997, n=2003, nnz_per_col=7, seed=11)
    a = read_mps_native(path)
    b = read_mps(path)
    assert (a.m, a.n, a.nnz) == (b.m, b.n, b.nnz)
    assert (a.A != b.A).nnz == 0
    np.testing.assert_array_equal(a.AL, b.AL)
    np.testing.assert_array_equal(a.AU, b.AU)
    np.testing.assert_array_equal(a.l, b.l)
    np.testing.assert_array_equal(a.u, b.u)
    np.testing.assert_array_equal(a.c, b.c)

    # gzip round trip through the native block reader
    gz = os.path.join(tmp_path, "gen.mps.gz")
    with open(path, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    agz = read_mps_native(gz)
    assert (agz.A != a.A).nnz == 0


FIXTURES = os.path.join(os.path.dirname(__file__), os.pardir, "data",
                        "fixtures")


@pytest.mark.parametrize("name,fmt,opt", [
    ("ranges_edge.mps", "free", -24.0),
    ("fixed_names.mps", "fixed", -26.4),
    ("bounds_defaults.mps", "free", -19.5),
])
def test_committed_fixtures_solve(name, fmt, opt):
    """Committed MPS fixtures with RANGES / fixed-format / bound-card
    edge cases (benchmark-suite stand-ins): both readers agree and the
    solve reaches the hand-computed optimum."""
    path = os.path.join(FIXTURES, name)
    prob = read_mps(path, mps_format=fmt)
    from hprlp_tpu.io.native_mps import is_available, read_mps_native

    if is_available():
        prob_n = read_mps_native(path, mps_format=fmt)
        assert prob_n.m == prob.m and prob_n.n == prob.n
        np.testing.assert_allclose(prob_n.AL, prob.AL)
        np.testing.assert_allclose(prob_n.AU, prob.AU)
        np.testing.assert_allclose(prob_n.l, prob.l)
        np.testing.assert_allclose(prob_n.u, prob.u)
        np.testing.assert_allclose(prob_n.c, prob.c)
        np.testing.assert_allclose(prob_n.A.toarray(), prob.A.toarray())

    import hprlp_tpu as hp

    res = hp.solve_problem(prob, hp.Parameters(verbose=False,
                                               stop_tol=1e-7,
                                               precision="f64"))
    assert res.status == "OPTIMAL"
    assert res.primal_obj == pytest.approx(opt, abs=1e-4)
