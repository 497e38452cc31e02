"""The port's reprolint (``repro_torch.analysis``): each pass flags a
violation planted in a fixture and honours its pragma,
``assert_compile_flat`` raises on a new dispatch key and stays quiet on a
repeated one, the static-key perturbation catches an uncovered knob, and
``--check`` reports no finding on the port's tree."""
import textwrap

import pytest
import torch

import repro_torch
import repro_torch.core as tcore
from repro_torch import analysis
from repro_torch.analysis import (__main__ as cli, common, docrefs, lanes,
                                  staticness, tripwire)


def _write(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return path


# (pass, fixture body, line of the violation)
PLANTED = {
    "lanes": ('''\
        from repro_torch.core import table as table_lib

        def hot(table, pages):
            return table[pages, table_lib.HOTNESS]
        ''', 4),
    "staticness": ('''\
        def step(table, params):
            if params.hot_threshold > 3:
                return table
            return None
        ''', 2),
    # The legacy name is spelled in two parts, so that no docrefs pass
    # finds it in this file.
    "docrefs": ('''\
        """Call %s to sweep the grid."""
        ''' % ("run" + "_sweep"), 1),
}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_pass_flags_planted_fixture_and_honours_pragma(tmp_path, name):
    body, line = PLANTED[name]
    bad = _write(tmp_path, f"bad_{name}.py", body)
    found = analysis.run_pass(name, paths=[bad])
    assert [(f.pass_name, f.line) for f in found] == [(name, line)]
    lines = textwrap.dedent(body).splitlines()
    lines[line - 1] += f"  # reprolint: allow[{name}] planted on purpose"
    ok = _write(tmp_path, f"ok_{name}.py", "\n".join(lines) + "\n")
    assert analysis.run_pass(name, paths=[ok]) == []


@pytest.mark.parametrize("body", [
    # a bare integer lane on a table-like value
    "def f(table, p):\n    return table[p, 2]\n",
    # the lane constants under the package's relative imports
    "from ..core import table as tl\n\ndef f(t):\n    return tl.WEAR\n",
    "from .table import FLAGS\n\ndef f(t):\n    return t[0] + FLAGS\n",
    "import repro_torch.core.table\n\n"
    "x = repro_torch.core.table.OWNER\n",
])
def test_lanes_flags_every_import_form(body):
    assert [f.pass_name for f in lanes.check_source(body, "x.py")] == \
        ["lanes"]


def test_lanes_allows_a_lane_named_to_the_lane_accessors():
    body = ("from ..core import table as table_lib\n"
            "from ..core.indexing import put_lane_, take_lane\n\n"
            "def f(table, rows, v):\n"
            "    put_lane_(table, rows, table_lib.FLAGS, v)\n"
            "    return take_lane(table, rows, lane=table_lib.DEVICE)\n")
    assert lanes.check_source(body, "x.py") == []


def test_staticness_sees_annotated_runtime_params():
    body = ("def f(q: 'RuntimeParams'):\n"
            "    return 1 if q.write_weight else 0\n")
    found = staticness.check_source(body, "x.py")
    assert [(f.pass_name, f.line) for f in found] == [("staticness", 2)]


def test_pragma_on_comment_line_covers_next_code_line():
    src = ("# reprolint: allow[lanes] why\n# more\nx = 1\ny = 2\n")
    assert common.pragma_lines(src) == {3: {"lanes"}}


def _tiny_engine(**kw):
    cfg = tcore.small_platform(chunk=8, n_fast_pages=24, **kw)
    return repro_torch.Engine(cfg, device="cpu")


def _trace(n):
    z = torch.zeros(n, dtype=torch.int32)
    return tcore.Trace(z, z, z.bool(), z + 64)


def test_assert_compile_flat_quiet_on_repeat_raises_on_new_key():
    eng = _tiny_engine()
    eng.run(_trace(16))
    with tripwire.assert_compile_flat(eng) as cc:
        eng.run(_trace(16))                  # the same key again
    assert cc.count == 0 and cc.new_entries == []
    with pytest.raises(tripwire.RecompileError, match="shape_sig"):
        with tripwire.assert_compile_flat(eng, msg="planted"):
            eng.run(_trace(40))              # a new trace length
    with tripwire.assert_compile_flat(eng, allow=1) as cc:
        eng.run(_trace(56))
    assert cc.count == 1


def test_tripwire_fixture_and_adoption_sites(tmp_path):
    fixture = _write(tmp_path, "bad_tripwire.py", '''\
        import torch
        import repro_torch
        import repro_torch.core as tcore
        from repro_torch.analysis.tripwire import assert_compile_flat


        def reprolint_case():
            def run():
                cfg = tcore.small_platform(chunk=8, n_fast_pages=20)
                eng = repro_torch.Engine(cfg, device="cpu")
                z = torch.zeros(72, dtype=torch.int32)
                with assert_compile_flat(eng):
                    eng.run(tcore.Trace(z, z, z.bool(), z + 64))
            return {"kind": "tripwire", "run": run, "line": 12}
        ''')
    found = analysis.run_pass("tripwire", paths=[fixture])
    assert [(f.pass_name, f.line) for f in found] == [("tripwire", 12)]
    # an adoption site that drops the tripwire is a finding
    root = tmp_path / "repo"
    for site in tripwire.ADOPTION_SITES:
        (root / site).parent.mkdir(parents=True, exist_ok=True)
        (root / site).write_text("x = 1\n")
    found = tripwire.run_repo(root)
    assert sorted(f.path for f in found) == sorted(tripwire.ADOPTION_SITES)


def test_static_key_perturbation_catches_an_uncovered_knob(monkeypatch):
    from repro_torch.core import config
    real = config.static_key

    def without_chunk(cfg):
        return tuple(v for v in real(cfg) if v != cfg.chunk)
    monkeypatch.setattr(config, "static_key", without_chunk)
    found = staticness.check_static_key_completeness(common.repo_root())
    assert any("`chunk`" in f.message and "NEITHER" in f.message
               for f in found), [f.format() for f in found]


def test_static_key_perturbation_clean_on_the_port():
    assert staticness.check_static_key_completeness(common.repo_root()) == []
    assert staticness.check_float_fields(common.repo_root()) == []


def test_cli_check_clean_on_the_port(capsys):
    assert cli.main(["--check"]) == 0
    out = capsys.readouterr().out
    assert "reprolint: 0 finding(s) [lanes, staticness, tripwire, docrefs]" \
        in out


def test_cli_fixture_mode_and_report(tmp_path, capsys):
    bad = _write(tmp_path, "bad.py", PLANTED["docrefs"][0])
    report = tmp_path / "r.json"
    assert cli.main(["--pass", "docrefs", "--report", str(report),
                     str(bad)]) == 1
    import json
    data = json.loads(report.read_text())
    assert [f["pass_name"] for f in data["findings"]] == ["docrefs"]
    assert "1 finding(s)" in capsys.readouterr().out


def test_scan_roots_are_the_ports():
    root = common.repo_root()
    files = {common.rel(p, root) for p in common.iter_py_files(root)}
    assert "src/repro_torch/engine.py" in files
    assert "examples/quickstart_torch.py" in files
    assert "chip_smoke.py" in files
    assert not any(f.startswith(("src/repro/", "tests/")) for f in files)
    assert not any("/analysis/" in f for f in files)
    assert "examples/quickstart.py" not in files
