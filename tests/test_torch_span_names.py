"""The port's flight-recorder span names: colon-case, declared exactly once
in ``torchsnapshot_tpu_torch/telemetry/names.py``, and every call site
passes a constant from it, ``telemetry.timed_span`` included.

The same lint rules that hold the JAX package (``tools/snaplint``), run
over the port's own registry and sources. This file imports no ``jax``.
"""

import ast
import sys
from pathlib import Path

import pytest

_REPO = Path(__file__).resolve().parent.parent
if str(_REPO) not in sys.path:
    sys.path.insert(0, str(_REPO))

from tools.snaplint.rules.names_lint import (  # noqa: E402
    check_metric_call_sites,
    check_metric_names_file,
    check_span_call_sites,
    check_span_names_file,
)

PORT = _REPO / "torchsnapshot_tpu_torch"
# The recorder passes its callers' names through span()/instant(); it
# declares none itself.
EXEMPT = {PORT / "telemetry" / "trace.py"}


def timed_span_literals(package: Path):
    """``path:line`` of each ``timed_span(...)`` call whose span name, the
    first argument or ``span=``, is a string literal."""
    found = []
    for py in sorted(package.rglob("*.py")):
        for node in ast.walk(ast.parse(py.read_text())):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            called = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")
            if called != "timed_span":
                continue
            given = node.args[:1] + [k.value for k in node.keywords if k.arg == "span"]
            if any(isinstance(a, ast.Constant) and isinstance(a.value, str) for a in given):
                found.append(f"{py.relative_to(package.parent)}:{node.lineno}")
    return found


def test_port_span_names_are_declared_once_in_colon_case():
    assert check_span_names_file(PORT / "telemetry" / "names.py") == []


def test_port_call_sites_use_the_constants():
    assert check_span_call_sites(PORT, exempt=EXEMPT) == []


@pytest.mark.parametrize(
    "source, found",
    [
        ("", False),
        ('with telemetry.timed_span("layer:op", hist):\n    pass\n', True),
        ('@timed_span(span="layer:op")\ndef f():\n    pass\n', True),
        ("with telemetry.timed_span(names.SPAN_GOOD, hist):\n    pass\n", False),
    ],
)
def test_no_timed_span_gets_a_literal_name(tmp_path, source, found):
    """The port passes constants; a planted literal is caught."""
    assert timed_span_literals(PORT) == []
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(source)
    assert bool(timed_span_literals(pkg)) is found


def test_port_metric_names_are_declared_once_and_call_sites_use_them():
    """The registry's series (the LFM2 model's routing counters among them)
    are snake_case, declared once, and every ``counter_inc`` /
    ``gauge_set`` / ``histogram_observe`` of the port passes a constant."""
    names_file = PORT / "telemetry" / "names.py"
    assert check_metric_names_file(names_file) == []
    assert check_metric_call_sites(PORT, names_file) == []


@pytest.mark.parametrize(
    "source, found",
    [
        ("from .telemetry import names\nreg.counter_inc(names.MOE_ASSIGNMENTS_TOTAL, 3, held='1')\n", False),
        ("reg.counter_inc('moe_assignments_total', 3, held='1')\n", True),
    ],
)
def test_a_literal_counter_name_is_caught(tmp_path, source, found):
    """A planted literal series name at a call site is caught; the constant passes."""
    pkg = tmp_path / "pkg"
    (pkg / "telemetry").mkdir(parents=True)
    (pkg / "telemetry" / "names.py").write_text('MOE_ASSIGNMENTS_TOTAL = "moe_assignments_total"\n')
    (pkg / "mod.py").write_text(source)
    assert bool(check_metric_call_sites(pkg, pkg / "telemetry" / "names.py")) is found
