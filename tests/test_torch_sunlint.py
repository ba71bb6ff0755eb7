"""sunlint for the PyTorch port (``repro_torch.analysis.lint``), on the
CPU: every rule flags its fixture (through the API and the CLI) and is
clean on the port's tree; the suppression machinery; bounded-loops'
reading of loop guards; table-coherence's cache and doc checks;
kernel-contract's launch half; the dispatch walker of hot-loop-layout and
dtype-drift (seeded permute-copies and casts inside a marked region, the
allowlist, the Newton trips of ``ensemble_bdf`` and ``ensemble_dirk``);
the CLI's exit codes and ``--list``."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import fixtures, hotloop, lint
from repro_torch.analysis.rules import bounded
from repro_torch.core import loops
from repro_torch.kernels import block_solve

FIXTURES = lint.load_fixtures()
RULE_NAMES = sorted(lint.load_rules())


@pytest.fixture(scope="module")
def clean_ctx():
    return lint.LintContext()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_flagged_by_expected_rule(name):
    expected_rule, setup = FIXTURES[name]
    ctx = lint.LintContext()
    setup(ctx)
    violations = lint.run_rules(ctx, [expected_rule])
    assert violations, (name, expected_rule)
    assert all(v.rule == expected_rule for v in violations)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_cli_exits_nonzero(name):
    assert lint.main(["--fixture", name, "--no-baseline"]) == 1


def test_every_rule_has_a_fixture():
    assert {rule for rule, _ in FIXTURES.values()} == set(RULE_NAMES)
    assert set(RULE_NAMES) == {"kernel-contract", "table-coherence",
                               "bounded-loops", "hot-loop-layout",
                               "dtype-drift"}


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_rule_clean_on_the_ports_tree(clean_ctx, rule):
    assert lint.run_rules(clean_ctx, [rule]) == []


def test_check_cli_clean_on_the_ports_tree(capsys):
    assert lint.main(["--check"]) == 0
    assert "sunlint: 0 violations (5 rules" in capsys.readouterr().out


def test_cli_list_names_every_rule(capsys):
    assert lint.main(["--list"]) == 0
    out = capsys.readouterr().out
    for rule in RULE_NAMES:
        assert rule in out


def test_cli_unknown_rule_and_fixture_exit_1():
    assert lint.main(["--rule", "no-such-rule"]) == 1
    assert lint.main(["--fixture", "no-such-fixture"]) == 1


# ---------------------------------------------------------------------------
# suppression
# ---------------------------------------------------------------------------


def test_baseline_exact_and_prefix_matching():
    v = lint.Violation("bounded-loops", "core/krylov.py:162", "msg")
    assert lint.is_suppressed(v, ["bounded-loops|core/krylov.py:162"])
    assert lint.is_suppressed(v, ["bounded-loops|core/*"])
    assert not lint.is_suppressed(v, ["bounded-loops|core/arkode*"])
    assert not lint.is_suppressed(v, ["table-coherence|core/*"])


def test_baseline_file_parsing(tmp_path):
    p = tmp_path / ".sunlint-torch-baseline"
    p.write_text("# comment only\n\n"
                 "bounded-loops|core/krylov.py*  # trailing comment\n")
    assert lint.load_baseline(p) == ["bounded-loops|core/krylov.py*"]
    assert lint.load_baseline(tmp_path / "missing") == []
    assert lint.LintContext().baseline_path.name == ".sunlint-torch-baseline"


def test_source_comment_suppression(tmp_path):
    src = tmp_path / "loops.py"
    src.write_text(
        "def run(t, tf):\n"
        "    while t < tf:  # sunlint: disable=bounded-loops (t doubles)\n"
        "        t = 2 * t\n"
        "    while t > 0:  # sunlint: disable=table-coherence\n"
        "        t = t - 1.0\n")
    ctx = lint.LintContext()
    ctx.loop_sources = [lint.LoopSource("loops", src)]
    found = lint.run_rules(ctx, ["bounded-loops"])
    assert [v.src for v in found] == [(str(src), 2), (str(src), 4)]
    lint._SRC_CACHE.clear()
    assert [lint.is_suppressed(v, []) for v in found] == [True, False]


# ---------------------------------------------------------------------------
# bounded-loops: what bounds a loop
# ---------------------------------------------------------------------------

LOOPS = {
    "counter_under_and": ("while it < opts.maxiter and r > tol:\n"
                          "    it += 1", True),
    "counter_under_or": ("while r > tol or it < maxiter:\n"
                         "    it += 1", False),
    "float_only": ("while t < tf * (1 - 1e-12):\n    t = t + h", False),
    "equality_only": ("while it != max_iters:\n    it += 1", False),
    "wrong_direction": ("while it > max_steps:\n    it -= 1", False),
    "reversed_operands": ("while max_restarts > restarts and go:\n"
                          "    restarts += 1", True),
    "head_continue": ("while True:\n"
                      "    active = t < tf\n"
                      "    if not read(active.any() & (att < opts.max_steps)"
                      ".all()):\n"
                      "        break\n"
                      "    att = att + 1", True),
    "head_exit": ("while True:\n"
                  "    if it >= newton_max or conv:\n"
                  "        break\n"
                  "    it += 1", True),
    "head_exit_under_and": ("while True:\n"
                            "    if it >= newton_max and conv:\n"
                            "        break\n"
                            "    it += 1", False),
    "no_head_guard": ("while True:\n"
                      "    for i in range(3):\n"
                      "        pass\n"
                      "    if it >= maxiter:\n"
                      "        break", False),
    "helper_return": ("def _go_on(t, tf, n, opts):\n"
                      "    return t < tf and n < opts.max_steps\n"
                      "while _go_on(t, tf, n, opts):\n"
                      "    n += 1", True),
    "negated_mask": ("while it < maxiter and trip(~conv):\n"
                     "    it += 1", True),
}


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_bounded_loops_reads_the_guard(case):
    text, bounded_ok = LOOPS[case]
    ctx = lint.LintContext()
    ctx.loop_sources = [lint.LoopSource(case, ctx.repo_root / f"{case}.py",
                                        text + "\n")]
    found = lint.run_rules(ctx, ["bounded-loops"])
    assert (found == []) == bounded_ok, found


def test_bounded_loops_reads_every_step_loop_of_the_port():
    import ast
    ctx = lint.LintContext()
    assert [s.name for s in ctx.loop_sources] == list(lint.LOOP_MODULES)
    loops = 0
    for source in ctx.loop_sources:
        tree = ast.parse(source.read())
        loops += sum(isinstance(n, ast.While) for n in ast.walk(tree))
    assert loops >= 14
    assert lint.run_rules(ctx, ["bounded-loops"]) == []
    assert fixtures.UNBOUNDED_LOOPS.count("while") == 3
    ctx.loop_sources = [lint.LoopSource("f", ctx.repo_root / "f.py",
                                        fixtures.UNBOUNDED_LOOPS)]
    assert len(lint.run_rules(ctx, ["bounded-loops"])) == 3
    assert "maxiter" in bounded.__doc__


# ---------------------------------------------------------------------------
# table-coherence: the port's caches
# ---------------------------------------------------------------------------


def _cache_file(path, ops):
    path.write_text(json.dumps({"schema": 1, "device": "h100_sxm",
                                "entries": {f"{op}|k": {"sig": {"op": op}}
                                            for op in ops}}))


def test_table_coherence_reads_the_ports_caches(tmp_path):
    ctx = lint.LintContext()
    ctx.cache_dir = tmp_path
    _cache_file(tmp_path / "h100_sxm.json",
                ["lagrange_rescale_soa", "block_solve_soa"])
    assert lint.run_rules(ctx, ["table-coherence"]) == []
    _cache_file(tmp_path / "other.json", ["frobnicate_soa"])
    (tmp_path / "broken.json").write_text("{not json")
    found = lint.run_rules(ctx, ["table-coherence"])
    assert sorted(v.where for v in found) == ["autotune:broken.json",
                                              "autotune:other.json"]
    # the reference's own caches are not the port's
    from repro_torch.core.autotune import default_cache_dir
    assert default_cache_dir().name != ".autotune"


# ---------------------------------------------------------------------------
# kernel-contract: the launch half reads the sources
# ---------------------------------------------------------------------------


def test_kernel_contract_holds_the_stated_sizes_to_the_sources(monkeypatch):
    ctx = lint.LintContext()
    ctx.cuda = False
    assert lint.run_rules(ctx, ["kernel-contract"]) == []
    monkeypatch.setattr(block_solve, "GJ_WARPS", 8)
    found = lint.run_rules(ctx, ["kernel-contract"])
    assert any(v.where == "launch:block_solve.cu:GJ_WARPS" for v in found)


def test_kernel_contract_holds_the_fused_newton_width_to_its_source(
        monkeypatch):
    """``kernels.newton.RESIDUAL_MAX_N`` (the widest block the fused
    Newton iteration takes) must name ``newton.cu``'s ``#define``."""
    from repro_torch.kernels import newton
    ctx = lint.LintContext()
    ctx.cuda = False
    monkeypatch.setattr(newton, "RESIDUAL_MAX_N", 16)
    found = lint.run_rules(ctx, ["kernel-contract"])
    assert [v.where for v in found] == ["launch:newton.cu:RESIDUAL_MAX_N"]


def test_kernel_contract_without_a_signature_grid():
    ctx = lint.LintContext()
    ctx.cuda = False
    sigs = dict(ctx.contract_sigs)
    sigs.pop("dot")
    ctx.contract_sigs = sigs
    found = lint.run_rules(ctx, ["kernel-contract"])
    assert [v.where for v in found] == ["dot"]


# ---------------------------------------------------------------------------
# the dispatch walker: hot-loop-layout and dtype-drift
# ---------------------------------------------------------------------------


def _seeded(body):
    """A target whose one 'trip' runs ``body`` inside a marked region,
    with ops outside the region around it."""
    def run():
        x = torch.arange(12, dtype=torch.float64).reshape(3, 4)
        x.T.contiguous()                     # outside: not recorded
        with loops.region("fixture:newton"):
            body(x)
        x.float()

    return hotloop.HotLoopTarget("seeded", run)


SEEDED_LAYOUT = {
    "contiguous": lambda x: x.T.contiguous(),
    "clone": lambda x: x.permute(1, 0).clone(),
    "copying_reshape": lambda x: x.T.reshape(-1),
    "copy_into": lambda x: torch.empty(4, 3, dtype=x.dtype).copy_(x.T),
    "view_of_permute": lambda x: x.T[1:].contiguous(),
    "transpose_movedim": lambda x: x.unsqueeze(0).movedim(2, 0).clone(),
}


@pytest.mark.parametrize("case", sorted(SEEDED_LAYOUT))
def test_hot_loop_layout_flags_a_seeded_permute_copy(case):
    ctx = lint.LintContext()
    ctx.hot_loop_targets = [_seeded(SEEDED_LAYOUT[case])]
    got = lint.run_rules(ctx, ["hot-loop-layout"])
    assert len(got) >= 1 and all(":fixture:newton:" in v.where for v in got)
    assert got[0].src[0] == __file__
    assert lint.run_rules(ctx, ["dtype-drift"]) == []


def test_hot_loop_layout_passes_views_and_contiguous_copies():
    def body(x):
        x.T @ x                               # a permuted operand, no copy
        x.T.sum(0)
        x.clone().reshape(-1)                 # a copy of an unpermuted x
        x[:1].T.contiguous()                  # permuted, already contiguous

    ctx = lint.LintContext()
    ctx.hot_loop_targets = [_seeded(body)]
    assert lint.run_rules(ctx, ["hot-loop-layout", "dtype-drift"]) == []


SEEDED_DTYPE = {
    "truncation_to": (lambda x: x.to(torch.float32), ("float64", "float32")),
    "promotion_float": (lambda x: x.float().double(), ("float32", "float64")),
    "implicit_promotion": (lambda x: x * torch.ones(4, dtype=torch.float32),
                           ("float32", "float64")),
    "copy_into": (lambda x: torch.empty(3, 4).copy_(x),
                  ("float64", "float32")),
    "half": (lambda x: x.half(), ("float64", "float16")),
}


@pytest.mark.parametrize("case", sorted(SEEDED_DTYPE))
def test_dtype_drift_flags_a_seeded_cast_and_the_allowlist_silences_it(case):
    body, pair = SEEDED_DTYPE[case]
    ctx = lint.LintContext()
    ctx.hot_loop_targets = [_seeded(body)]
    got = lint.run_rules(ctx, ["dtype-drift"])
    assert got and all(v.rule == "dtype-drift" for v in got)
    assert any(f"{pair[0]} -> {pair[1]}" in v.message for v in got)
    ctx.dtype_allowlist = {("float64", "float32"), ("float32", "float64"),
                           ("float64", "float16")}
    assert lint.run_rules(ctx, ["dtype-drift"]) == []


def test_walker_sees_every_newton_trip_of_both_integrators():
    """The walker records only the marked trips, and both integrators'
    trips are marked: the default targets run ops in each region."""
    ctx = lint.LintContext()
    names = [t.name for t in ctx.hot_loop_targets]
    assert names == ["ensemble_bdf", "ensemble_dirk"]
    calls = {n: ctx.hot_loop_trace(t).calls
             for n, t in zip(names, ctx.hot_loop_targets)}
    assert set(calls["ensemble_bdf"]) == {"ensemble_bdf:newton"}
    assert set(calls["ensemble_dirk"]) == {"ensemble_dirk:newton"}
    assert all(n > 50 for c in calls.values() for n in c.values())
    assert loops.regions == []
    with pytest.raises(RuntimeError, match="saw no trip"):
        hotloop.trace(hotloop.HotLoopTarget("none", lambda: None))


def test_aos_boundary_findings_name_the_wrapper():
    """The fixture's AoS right-hand side: every finding is the
    integrator's boundary transpose (``batched._wrap_soa``), in both
    integrators' trips."""
    ctx = lint.LintContext()
    fixtures.FIXTURES["aos_rhs"][1](ctx)
    got = lint.run_rules(ctx, ["hot-loop-layout"])
    regions = {v.where.split(":")[3] for v in got}
    assert regions == {"ensemble_bdf", "ensemble_dirk"}
    assert all("repro_torch.core.batched.<lambda>:clone" in v.where
               for v in got)
    assert all(v.src[0].endswith("core/batched.py") for v in got)
