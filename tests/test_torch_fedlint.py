"""fedlint over the port, with ``tool/fedlint`` as it is.

The linter's path-scoped rules name the JAX package's directory
(``rayfed_tpu/``), so the port is linted from a temporary root in which
``rayfed_tpu`` is a symlink to ``rayfed_tpu_torch/``: every rule sees the
port's files under the paths it scopes.  A deliberate finding carries the
JAX package's pragma and reason (``# fedlint: disable=FED004 — ...``).
"""

import os
from pathlib import Path

import pytest

from tool.fedlint.engine import load_project, lint_paths
from tool.fedlint.rules import ALL_RULES, declared_meta_keys

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "rayfed_tpu_torch"


@pytest.fixture(scope="module")
def port_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fedlint_port")
    os.symlink(PORT, root / "rayfed_tpu")
    return str(root)


def test_port_has_no_visible_findings(port_root):
    visible, suppressed = lint_paths(("rayfed_tpu",), root=port_root)
    assert [f.render() for f in visible] == []
    # The deliberate ones carry the JAX package's pragmas and reasons
    # (errors handed to another thread, a loop-affine call made on the
    # loop, a lock never contended from sync threads): the port suppresses
    # no rule the reference does not.
    ref_visible, ref_suppressed = lint_paths(("rayfed_tpu",), root=str(ROOT))
    assert not ref_visible
    assert suppressed and {f.code for f in suppressed} <= {f.code for f in ref_suppressed}


@pytest.mark.parametrize("rule", ALL_RULES, ids=lambda r: r.code)
def test_each_rule_passes_over_the_port(port_root, rule):
    visible, _ = lint_paths(("rayfed_tpu",), root=port_root, rules=[rule])
    assert [f.render() for f in visible] == []


def test_the_walk_reaches_every_port_module(port_root):
    """The symlinked root is walked, not skipped: every module of the port
    is parsed under the JAX package's path."""
    project, errors = load_project(("rayfed_tpu",), root=port_root)
    want = {
        "rayfed_tpu/" + p.relative_to(PORT).as_posix()
        for p in PORT.rglob("*.py") if "__pycache__" not in p.parts
    }
    assert not errors and {f.path for f in project.files} == want


def test_the_port_declares_the_reference_wire_keys():
    """FED006 holds literal frame-metadata keys to the ``*_KEY`` constants of
    ``transport/wire.py``; the port's wire declares the same set."""
    ref = declared_meta_keys(str(ROOT / "rayfed_tpu" / "transport" / "wire.py"))
    port = declared_meta_keys(str(PORT / "transport" / "wire.py"))
    assert port == ref and ref
