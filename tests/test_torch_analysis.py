"""The port's reprolint (``repro_torch.analysis``): each pass flags a
violation planted in a fixture and honours its pragma,
``assert_compile_flat`` raises on a new dispatch key and stays quiet on a
repeated one, the static-key perturbation catches an uncovered knob, and
``--check`` reports no finding on the port's tree. The four passes that
the JAX package runs on jaxprs, restated for PyTorch: the schedule's
recorder on a step that breaks the contract, the storage identity of a
copied state, the budget (a leaf missing from ``PARAM_BOUNDS``, the
horizon, the budget run saturating without a wrap, through ``--report``),
an index past the table, the shared-memory footprints and the guard
bands; the CLI's ``--baseline``."""
import ast
import json
import textwrap

import pytest
import torch

import repro_torch
import repro_torch.core as tcore
from repro_torch import analysis
from repro_torch.analysis import (__main__ as cli, common, docrefs,
                                  donation, kernel_san, lanes, ranges,
                                  schedule, staticness, tripwire)


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
    # a whole-table copy, recorded under the schedule's dispatch mode
    "schedule": ('''\
        import torch

        def snapshot(table):
            return table.clone()

        def reprolint_case():
            table = torch.zeros(2, 16, 8, dtype=torch.int32)
            return {"kind": "schedule", "make": lambda: (snapshot, (table,))}
        ''', 4),
    # a donated state read after the run that consumed it
    "donation": ('''\
        def rerun(eng, trace, state):
            new = eng.run(trace, state=state)
            return state.table, new
        ''', 3),
    # a negative page wraps silently in PyTorch
    "ranges": ('''\
        import torch

        def lookup(table):
            return table[torch.tensor([0, -1])]

        def reprolint_case():
            table = torch.zeros(16, 8, dtype=torch.int32)
            return {"kind": "ranges", "make": lambda: (lookup, (table,))}
        ''', 4),
    # the RWKV scan's block at chunk 256 and width 128: past the card's
    # shared memory, with no workspace
    "kernel_san": ('''\
        from repro_torch.kernels import rwkv_scan

        def reprolint_case():
            return {"kind": "kernel_san", "line": 5, "make": lambda: [
                ("rwkv", rwkv_scan.smem_bytes(256, 128, 128), False)]}
        ''', 5),
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
    assert "reprolint: 0 finding(s) [schedule, donation, lanes, " \
        "staticness, tripwire, docrefs, ranges, kernel_san]" in out


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


# ------------------------------------------------- the passes on jaxprs' side
def test_schedule_flags_writes_out_of_the_contract():
    where = ("src/repro_torch/kernels/chunk_step.py", 1)
    commit = ("write", "scatter_add_", where, "whole")
    events = [("write", "index_put_", where, ("lane", 6)),   # before
              ("read", "index", where, None), commit,
              ("write", "copy_", where, ("lane", 2)),        # the decay
              ("write", "index_put_", where, ("lane", 6)),   # the stamp
              commit,                                        # a second
              ("write", "copy_", where, ("lane", 3))]        # WEAR after
    found, summary = schedule.check_events(events, "planted")
    msgs = [f.message for f in found]
    assert len(msgs) == 3, msgs
    assert "before the boundary commit" in msgs[0]
    assert "a second boundary commit" in msgs[1]
    assert "('lane', 3) after the commit" in msgs[2]
    assert summary == {"label": "planted", "reads_before_commit": 1,
                       "commit": True, "decay": 1, "stamp": 1}


def test_schedule_records_the_step_on_both_routes():
    assert schedule.run_repo(common.repo_root()) == []
    assert [s["label"] for s in schedule.LAST_SUMMARY] == \
        ["scan-path", "plain-kernel-b"]
    for s in schedule.LAST_SUMMARY:
        assert s["commit"] and s["decay"] == 1 and s["stamp"] == 1
        assert s["reads_before_commit"] >= 3


def test_donation_storage_identity_flags_a_copied_state(tmp_path):
    fixture = _write(tmp_path, "copied.py", '''\
        import torch
        from repro_torch.core import emulator, small_platform

        def reprolint_case():
            state = emulator.init_state(small_platform())
            return {"kind": "donation", "line": 7,
                    "make": lambda: (emulator.clone_state, state)}
        ''')
    found = analysis.run_pass("donation", paths=[fixture])
    assert [(f.pass_name, f.line) for f in found] == [("donation", 7)]
    assert "not in the passed state's memory" in found[0].message
    st = tcore.emulator.init_state(tcore.small_platform())
    assert donation.kept_storage(st, st) == []


def test_donation_registry_flags_an_unregistered_in_place_site():
    source = ("def f(cfg, reg, st, params, sc, bf, *req):\n"
              "    return step_batch(cfg, reg, st, params, sc, bf, *req)\n")
    found = donation._check_site_registry(ast.parse(source),
                                          "src/repro_torch/extra.py")
    assert [(f.line, "step_batch" in f.message) for f in found] == \
        [(2, True)]
    assert donation._check_site_registry(
        ast.parse(source), "src/repro_torch/engine.py") == []


def test_ranges_budget_leaf_missing_and_horizon(monkeypatch):
    cfg = tcore.small_platform()
    assert ranges.validate_budget(cfg) == []
    bounds = dict(ranges.PARAM_BOUNDS)
    del bounds["issue_gap"]
    monkeypatch.setattr(ranges, "PARAM_BOUNDS", bounds)
    assert ranges.validate_budget(cfg) == [
        "params leaf `issue_gap` missing from PARAM_BOUNDS"]
    monkeypatch.undo()
    h = ranges.horizon(cfg)
    assert h["int32_horizon_chunks"] >= ranges.N_CHUNKS_BUDGET
    assert h["per_chunk_growth"] == max(h["by_chunk"].values())


def test_ranges_budget_run_saturates_without_a_wrap(tmp_path, capsys):
    """N_CHUNKS_BUDGET chunks at small_platform from lanes and counters
    just under their caps, through the CLI's --report."""
    report = tmp_path / "r.json"
    assert cli.main(["--pass", "ranges", "--report", str(report)]) == 0
    out = capsys.readouterr().out
    assert "saturated, nothing wrapped" in out
    bounds = json.loads(report.read_text())["proved_bounds"]
    run = next(b for b in bounds if b["label"] == "budget_run")
    assert run["n_chunks"] == ranges.N_CHUNKS_BUDGET
    assert run["problems"] == []
    ends = run["ends"]
    assert ends["HOTNESS"][1] == tcore.table.HOTNESS_CAP
    assert ends["WEAR"][1] == tcore.table.WEAR_CAP
    assert ends["clock"] == ranges.INT32_MAX      # the horizon's edge
    assert ends["swaps_done"] > 0                 # EPOCH written near it
    assert ends["EPOCH"][1] > run["time0"]


def test_ranges_saturation_sees_a_wrap():
    cfg = ranges.budget_config()
    st = ranges.budget_state(cfg, tcore.RuntimeParams.from_config(cfg), 5,
                             100)
    problems, _ = ranges.saturation(st, 5, 100)
    assert any("not saturated" in p for p in problems)
    st.clock.fill_(-7)
    problems, _ = ranges.saturation(st, 5, 100)
    assert any("clock at -7" in p and "wrapped" in p for p in problems)


def test_kernel_san_footprints_and_guard_bands():
    rows = kernel_san.footprints()
    labels = [r[0] for r in rows]
    assert sum(x.startswith("flash_attention") for x in labels) == 9
    assert any(x.startswith("rwkv_scan rwkv6-7b") for x in labels)
    assert kernel_san.check_footprints(rows) == []
    b4096 = next(b for x, b, _ in rows if x.startswith("chunk_step chunk "
                                                      "4096"))
    assert b4096 > kernel_san.H100_SMEM_OPTIN     # sent to the workspace
    with kernel_san.GuardedAlloc(0xFF) as alloc:
        t = torch.empty(10, dtype=torch.int32)
        assert int(t[0]) == -1                    # the poison
        torch.as_strided(t, (11,), (1,))[10] = 7  # one past the end
    assert alloc.damaged() == [
        "torch.empty (10,) torch.int32: 4 guard bytes written past the "
        "buffer"]


def test_cli_baseline_hides_known_findings(tmp_path, capsys):
    bad = _write(tmp_path, "bad.py", PLANTED["docrefs"][0])
    report = tmp_path / "r.json"
    assert cli.main(["--pass", "docrefs", "--report", str(report),
                     str(bad)]) == 1
    assert cli.main(["--pass", "docrefs", "--baseline", str(report),
                     str(bad)]) == 0
    assert "1 finding(s), 0 new vs baseline" in capsys.readouterr().out
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"findings": []}))
    assert cli.main(["--pass", "docrefs", "--baseline", str(empty),
                     str(bad)]) == 1
