"""The hot-path lint (``tools/lint_hotpath.py``, loaded by path and run
unchanged) over the port's counterparts of what it checks in ``repro``:
the scheduler's tick functions and the engine's ``_pick`` (R1 dense
allocations, R2 unpacks, R5 file syncs, R6 prefix-cache traffic), the
masked-sample dispatch module, the port's ``core/`` (R3 wall-clock and
global-RNG nondeterminism) and ``serving/`` (R4 swallowed exceptions).
No finding may stand; the two reviewed exceptions carry the reference's
``# hotpath-lint: allow`` marks on the same lines as there."""
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture(scope="module")
def lint():
    spec = importlib.util.spec_from_file_location(
        "lint_hotpath", ROOT / "tools" / "lint_hotpath.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _targets():
    yield "lint_scheduler", PORT / "serving" / "scheduler.py"
    yield "lint_engine", PORT / "serving" / "engine.py"
    yield "lint_kernel_dispatch", PORT / "kernels" / "masked_sample" / "ops.py"
    for p in sorted((PORT / "core").glob("*.py")):
        yield "lint_core_determinism", p
    for p in sorted((PORT / "serving").glob("*.py")):
        yield "lint_serving_excepts", p


@pytest.mark.parametrize("rule,path", [
    pytest.param(r, p, id=f"{r}:{p.relative_to(PORT)}")
    for r, p in _targets()])
def test_port_is_lint_clean(lint, rule, path):
    findings = getattr(lint, rule)(str(path))
    assert findings == [], "\n".join(map(str, findings))


def test_allow_marks_match_the_reference():
    """The port marks as reviewed exactly the lines the reference marks:
    the host sampler's unpack in ``_choose`` and ``_pick``'s."""
    def marked(path):
        return [ln.strip() for ln in path.read_text().splitlines()
                if "hotpath-lint: allow" in ln]
    for rel in ("serving/scheduler.py", "serving/engine.py"):
        ref = marked(ROOT / "src" / "repro" / rel)
        got = marked(PORT / rel)
        assert len(got) == len(ref) == 1
        assert got[0].split("#")[0].strip() == ref[0].split("#")[0].strip()


def test_prefix_cache_traffic_stays_off_the_tick(lint, tmp_path):
    """Rule R6 on the port's scheduler: a lookup or insert moved into a tick
    function is found."""
    src = (PORT / "serving" / "scheduler.py").read_text()
    anchor = "    def _plain_step(self) -> None:\n"
    assert anchor in src
    bad = tmp_path / "scheduler.py"
    bad.write_text(src.replace(
        anchor, anchor + "        self.prefix_cache.lookup([], 0)\n"))
    findings = lint.lint_scheduler(str(bad))
    assert [f.rule for f in findings] == ["R6"]
